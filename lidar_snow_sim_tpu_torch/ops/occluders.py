"""Phase A of the dense snowfall assembly, and the window assembly's
occluders: the nearest K occluders of each beam (counterpart of
`lidar_snow_sim_tpu/ops/pallas_occluders.py`).

Six kernels, all in `csrc/occluders.cu`, each with a wrapper that
launches it on CUDA tensors and runs its plain torch version on CPU
tensors. The dense assembly's five follow the arithmetic of the TPU
kernels: an exact hit test of every beam of a chunk against a candidate
list, then the K nearest hits in lax.top_k order over that list (ascending
range, ties to the lowest candidate column); W1 follows the JAX package's
window assembly.

- A1 (`find_occluders`, `occluders_plain`; TPU `_kernel`,
  pallas_occluders.py:150): every beam against one bank slice plus the
  row's whole wide list. The default layout.
- A2 (`find_occluders_routed`, `occluders_routed_plain`; TPU
  `_kernel_routed`, :584): each chunk in one of three modes, chosen by the
  layout from conservative per-group LUT bounds: 0 dead, 1 A1's body, 2
  each `group` of beams against its own `band`-wide window of the slice
  plus the first `wide_sl` wide columns. Chosen by `route_band > 0`.
- A3 (`find_occluders_banded`, `occluders_banded_plain`; TPU
  `_kernel_banded`, :423): each group against two bands, head- and
  tail-anchored, plus `wide_sl` wide columns, and a per-beam coverage
  plane. Chosen by `band_width > 0`, which supersedes `route_band`.
- A4a (`find_occluders_t`; TPU `_kernel_t`, :312): A1's function with each
  beam's candidates split across 8 lanes. Chosen by `pallas_transposed`.
- A4b (`find_occluders_pair`; TPU `_kernel_pair`, :747): A1's function on
  two chunks per CTA, each on its own threads; needs an even chunk count.
  Chosen by `pallas_pair`.
  A4a and A4b compute every chunk (the TPU kernels have no `has` gate), so
  their plain version, `occluders_ungated_plain`, is A1's with every chunk
  live.
- The folded A1 (`find_occluders_folded`, the TPU `batch_fold` rule,
  :1080-1128): B frames' A1 chunks in one A1 launch.
- W1 (`find_occluders_window`, `occluders_window_plain`): the window
  assembly's occluders, which the JAX package leaves to XLA
  (models/snowfall.py:112-148, 352-373): each point against its own
  angular window of `window_size` bank columns and its row's wide list,
  the nearest K hits with the window assembly's hit test
  (`ops/geometry.candidate_intervals`), outputs (N, K).

The dense assembly's five kernels run one lane-split body in the CUDA
source (W1 reuses its per-lane top-K and merge): a beam's
candidates split over a few lanes and merged in lax.top_k order. A1, A4a,
A4b and A2's mode-1 chunks test A1's whole list; A2's mode-2 chunks and A3
test their group's band runs and the wide prefix.

Wrap-pad dedup: a bank row repeats its narrow particles with period
`count`, so a candidate is kept only as the first copy counted from where
its list starts (A1 and mode 1: the slice start; mode 2: the band start;
A3: band A's start, and band B drops what band A holds). Copies carry
bit-identical properties, so the layouts agree.

Point-feature rows (`point_features`): [d_orig, right, left, sin_r, cos_r,
sin_l, cos_l, wrapped_beam, signed azimuth]. Bank property rows
(ParticleBank.data_t / wide_t): [x, y, r, dist, azimuth in [0, 2pi),
half-width, signed sort angle, 0].

Outputs: a12d (3K, n_chunks * blk) holding [a1; a2; dist], K outer, with
a1 = a2 = 0 and dist = 3e38 in empty slots (the TPU kernels leave a
retired column's a1/a2 there, so compare a1/a2 only where dist < 1e37), and
the per-beam overflow max(n_hit - K, 0) as (n_chunks, blk) int32. Dead
chunks (A1 `has == 0`, A2 mode 0) hold the empty-slot sentinels and zero
overflow; A3, A4a and A4b compute every chunk, as the TPU kernels do.
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.ops.geometry import (
    TWO_PI,
    beam_limits,
    candidate_angles,
    candidate_intervals,
    norm3,
)

BIG = 3.0e38
N_FEAT = 9
SANG_ROW = 6          # bank property row of the signed sort angle
MAX_OCCLUDERS = 512   # largest K the kernel's per-thread list is built for
_GROUP = 32           # chunks per step of the plain versions (bounds memory)


def point_features(x, y, z, beam_rad: float):
    """(n, 9) per-point feature rows for phase A (pallas_occluders.py:41)."""
    right, left = beam_limits(x, y, beam_rad)
    return torch.stack(
        [
            torch.sqrt(x * x + y * y + z * z), right, left,
            torch.sin(right), torch.cos(right),
            torch.sin(left), torch.cos(left),
            (right > left).to(torch.float32),
            torch.atan2(y, x),
        ],
        dim=-1,
    )


def _nearest(f, cand, keep, k_occ: int):
    """Hit test of beams f (B, P, 9) against candidates cand (B, C, 8),
    where keep (B, C) is set; the K nearest hits of each beam in candidate
    order. Returns (top (3, B, P, min(K, C)) [a1; a2; dist], ovf (B, P))."""
    px, py, pr, pdist, pang, halfw = (cand[:, None, :, i] for i in range(6))
    d_orig, right, left, sin_r, cos_r, sin_l, cos_l = (
        f[:, :, i:i + 1] for i in range(7)
    )                                                   # (B, P, 1)
    wrapped = f[:, :, 7:8] > 0.5

    center_in = (right <= pang) & (pang <= left)
    center_in |= wrapped & (right - TWO_PI <= pang) & (pang <= left)
    center_in |= wrapped & (right <= pang) & (pang <= left + TWO_PI)
    dist_r = torch.abs(px * sin_r - py * cos_r)
    dist_l = torch.abs(px * sin_l - py * cos_l)
    right_hit = (dist_r < pr) & (cos_r * px + sin_r * py > 0)
    left_hit = (dist_l < pr) & (cos_l * px + sin_l * py > 0)
    hit = (center_in | right_hit | left_hit) & (pdist < d_orig)
    hit &= keep[:, None, :]

    a1_raw = pang - halfw
    a1_raw = torch.where(a1_raw < 0, a1_raw + TWO_PI, a1_raw)
    a2_raw = pang + halfw
    a2_raw = torch.where(a2_raw > TWO_PI, a2_raw - TWO_PI, a2_raw)
    a1 = torch.where(right_hit, right, a1_raw)
    a2 = torch.where(left_hit, left, a2_raw)

    n_hit = hit.sum(dim=2)
    score = torch.where(hit, pdist, BIG)
    # stable sort: ascending range, ties to the lowest column
    val, idx = torch.sort(score, dim=2, stable=True)
    k_have = min(k_occ, val.shape[2])
    val, idx = val[:, :, :k_have], idx[:, :, :k_have]
    kept = val < BIG
    top = torch.stack([
        torch.where(kept, torch.gather(a1, 2, idx), 0.0),
        torch.where(kept, torch.gather(a2, 2, idx), 0.0),
        val,                                            # BIG where empty
    ])
    return top, (n_hit - k_occ).clamp_min(0).to(torch.int32)


def _empty(n_chunks: int, blk: int, k_occ: int, dev):
    """The [a1; a2; dist] planes (3, K, n_chunks, blk) and the overflow
    (n_chunks, blk) of chunks that hold no hit."""
    a12d = torch.zeros((3, k_occ, n_chunks, blk), dtype=torch.float32,
                       device=dev)
    a12d[2] = BIG
    return a12d, torch.zeros((n_chunks, blk), dtype=torch.int32, device=dev)


def _put(a12d, ovf, sl, top, o, blk: int):
    """Store the (3, B * blk // P, P, k) top lists of chunks `sl`."""
    k_have = top.shape[3]
    a12d[:, :k_have, sl] = top.reshape(3, len(sl), blk, k_have).permute(
        0, 3, 1, 2
    )
    ovf[sl] = o.reshape(len(sl), blk)


def _band_cands(props, row, starts, band: int, k_ext: int):
    """Bank columns starts[b, g] + j, j < band, of rows `row` (B,): their
    (B, G, band, 8) properties and column indices."""
    cols = starts[:, :, None] + torch.arange(band, device=row.device)
    return props[row[:, None, None], cols.clamp(max=k_ext - 1)], cols


def occluders_plain(feats, w0b, rows, los, has, counts, data_t, wide_t, *,
                    blk: int, w_sl: int, k_occ: int):
    """Plain torch version of kernel A1, _GROUP live chunks at a time."""
    n_chunks = rows.shape[0]
    k_ext = data_t.shape[2]
    dev = feats.device
    props = data_t.permute(0, 2, 1)                    # (C, k_ext, 8)
    wide = wide_t.permute(0, 2, 1)                     # (C, wc, 8)
    fb = feats.reshape(-1, blk, N_FEAT)
    a12d, ovf = _empty(n_chunks, blk, k_occ, dev)
    offs = torch.arange(w_sl, device=dev)
    live = torch.nonzero(has).flatten()
    for g0 in range(0, live.shape[0], _GROUP):
        sl = live[g0:g0 + _GROUP]
        row = rows[sl].long()
        cols = los[sl].long()[:, None] + offs[None, :]  # (B, w_sl)
        cand = torch.cat(
            [props[row[:, None], cols.clamp(max=k_ext - 1)], wide[row]], dim=1
        )                                               # (B, Ct, 8)
        # wrap-pad dedup (a slice column at or past the row's narrow count
        # repeats an earlier particle) and the end of the bank row
        keep = torch.cat(
            [
                (cols < k_ext) & (offs[None, :] < counts[row].long()[:, None]),
                torch.ones((row.shape[0], wide.shape[1]), dtype=torch.bool,
                           device=dev),
            ],
            dim=1,
        )
        top, o = _nearest(fb[w0b[sl].long()], cand, keep, k_occ)
        _put(a12d, ovf, sl, top, o, blk)
    return a12d.reshape(3 * k_occ, n_chunks * blk), ovf


def occluders_routed_plain(feats, w0b, rows, los, gloa, mode, counts, data_t,
                           wide_t, *, blk: int, w_sl: int, k_occ: int,
                           band: int, group: int, wide_sl: int):
    """Plain torch version of kernel A2: mode-1 chunks through A1's plain
    version, mode-2 chunks _GROUP at a time, each group of `group` beams
    against bank columns [gloa, gloa + band) then wide[:wide_sl]."""
    n_chunks = rows.shape[0]
    k_ext = data_t.shape[2]
    dev = feats.device
    g_dim = blk // group
    a12d, ovf = occluders_plain(
        feats, w0b, rows, los, (mode == 1).to(torch.int32), counts, data_t,
        wide_t, blk=blk, w_sl=w_sl, k_occ=k_occ,
    )
    a12d = a12d.reshape(3, k_occ, n_chunks, blk)
    props = data_t.permute(0, 2, 1)
    wide = wide_t.permute(0, 2, 1)[:, :wide_sl]
    fb = feats.reshape(-1, blk, N_FEAT)
    starts = gloa.reshape(n_chunks, g_dim).long()
    fast = torch.nonzero(mode == 2).flatten()
    for g0 in range(0, fast.shape[0], _GROUP):
        sl = fast[g0:g0 + _GROUP]
        nb = sl.shape[0]
        row = rows[sl].long()
        band_c, cols = _band_cands(props, row, starts[sl], band, k_ext)
        cand = torch.cat(
            [band_c, wide[row][:, None].expand(nb, g_dim, wide_sl, 8)], dim=2
        ).reshape(nb * g_dim, band + wide_sl, 8)
        # one copy per wrap period, counted from the band start
        j = torch.arange(band, device=dev)
        keep = torch.cat(
            [
                (cols < k_ext) & (j < counts[row].long()[:, None, None]),
                torch.ones((nb, g_dim, wide_sl), dtype=torch.bool,
                           device=dev),
            ],
            dim=2,
        ).reshape(nb * g_dim, -1)
        f = fb[w0b[sl].long()].reshape(nb * g_dim, group, N_FEAT)
        top, o = _nearest(f, cand, keep, k_occ)
        _put(a12d, ovf, sl, top, o, blk)
    return a12d.reshape(3 * k_occ, n_chunks * blk), ovf


def occluders_banded_plain(feats, w0b, rows, gloa, glob, counts, data_t,
                           wide_t, *, blk: int, k_occ: int, band: int,
                           group: int, wide_sl: int, delta: float):
    """Plain torch version of kernel A3, every chunk, _GROUP at a time.

    Each group of `group` beams tests bank columns [gloa, gloa + band)
    (band A), then [glob, glob + band) less the columns band A holds (band
    B), then wide[:wide_sl]. Returns (a12d, ovf, unc): unc (n_chunks, blk)
    int32 is 1 where a beam's sort-angle window [az - delta, az + delta]
    lies in neither band nor, when they overlap or adjoin, their union
    (pallas_occluders.py:536-556).
    """
    n_chunks = rows.shape[0]
    k_ext = data_t.shape[2]
    dev = feats.device
    g_dim = blk // group
    a12d, ovf = _empty(n_chunks, blk, k_occ, dev)
    unc = torch.zeros((n_chunks, blk), dtype=torch.int32, device=dev)
    props = data_t.permute(0, 2, 1)
    wide = wide_t.permute(0, 2, 1)[:, :wide_sl]
    fb = feats.reshape(-1, blk, N_FEAT)
    starts_a = gloa.reshape(n_chunks, g_dim).long()
    starts_b = glob.reshape(n_chunks, g_dim).long()
    delta = torch.full((), delta, dtype=torch.float32, device=dev)
    j = torch.arange(band, device=dev)
    for c0 in range(0, n_chunks, _GROUP):
        sl = torch.arange(c0, min(c0 + _GROUP, n_chunks), device=dev)
        nb = sl.shape[0]
        row = rows[sl].long()
        cnt = counts[row].long()[:, None, None]
        la, lb = starts_a[sl], starts_b[sl]             # (B, G)
        d_ab = (lb - la)[:, :, None]
        cand_a, cols_a = _band_cands(props, row, la, band, k_ext)
        cand_b, cols_b = _band_cands(props, row, lb, band, k_ext)
        cand = torch.cat(
            [cand_a, cand_b,
             wide[row][:, None].expand(nb, g_dim, wide_sl, 8)], dim=2,
        ).reshape(nb * g_dim, 2 * band + wide_sl, 8)
        keep = torch.cat(
            [
                (cols_a < k_ext) & (j < cnt),
                (cols_b < k_ext) & (d_ab + j >= band) & (d_ab + j < cnt),
                torch.ones((nb, g_dim, wide_sl), dtype=torch.bool,
                           device=dev),
            ],
            dim=2,
        ).reshape(nb * g_dim, -1)
        f = fb[w0b[sl].long()].reshape(nb * g_dim, group, N_FEAT)
        top, o = _nearest(f, cand, keep, k_occ)
        _put(a12d, ovf, sl, top, o, blk)

        sang = data_t[row, SANG_ROW]                    # (B, k_ext)

        def edge(c):
            return torch.gather(sang, 1, c.clamp(max=k_ext - 1))[:, :, None]

        s_a0, s_a1 = edge(la), edge(la + band - 1)      # (B, G, 1)
        s_b0, s_b1 = edge(lb), edge(lb + band - 1)
        azp = f[:, :, 8].reshape(nb, g_dim, group)
        need_l, need_r = azp - delta, azp + delta
        in_a = (s_a0 <= need_l) & (need_r <= s_a1)
        in_b = (s_b0 <= need_l) & (need_r <= s_b1)
        in_j = (d_ab <= band) & (s_a0 <= need_l) & (need_r <= s_b1)
        covered = (cnt <= band) | in_a | in_b | in_j
        unc[sl] = (~covered).reshape(nb, blk).to(torch.int32)
    return a12d.reshape(3 * k_occ, n_chunks * blk), ovf, unc


def _check_args(feats, w0b, rows, counts, data_t, wide_t, per_chunk,
                per_group, *, blk: int, k_occ: int, group: int = 1):
    """Raise unless the arguments are what the kernels take: contiguous
    CUDA tensors of the right types and shapes, K and blk in range."""
    n_chunks = rows.shape[0]
    c_banks, _, k_ext = data_t.shape
    if not 0 < k_occ <= MAX_OCCLUDERS:
        raise ValueError(f"max_occluders {k_occ} outside 1..{MAX_OCCLUDERS}")
    if not 0 < blk <= 1024 or feats.shape[0] % blk:
        raise ValueError(f"block_points {blk} must divide {feats.shape[0]} "
                         "and be at most 1024")
    if group <= 0 or blk % group:
        raise ValueError(f"band_group {group} must divide block_points {blk}")
    check = _kernels.check_input
    check("feats", feats, torch.float32, (feats.shape[0], N_FEAT))
    for name, t in dict(w0b=w0b, rows=rows, **per_chunk).items():
        check(name, t, torch.int32, (n_chunks,))
    for name, t in per_group.items():
        check(name, t, torch.int32, (n_chunks * (blk // group),))
    check("counts", counts, torch.int32, (c_banks,))
    check("data_t", data_t, torch.float32, (c_banks, 8, k_ext))
    check("wide_t", wide_t, torch.float32, (c_banks, 8, wide_t.shape[2]))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def find_occluders(feats, w0b, rows, los, has, counts, data_t, wide_t, *,
                   blk: int, w_sl: int, k_occ: int):
    """Phase A for `rows.shape[0]` chunks: kernel A1 on CUDA tensors, its
    plain version on CPU tensors.

    feats (n_pad, 9) f32; w0b, rows, los, has (n_chunks,) and counts (C,)
    int32; data_t (C, 8, k_ext) and wide_t (C, 8, wc) f32. Returns
    (a12d (3K, n_chunks * blk) f32, ovf (n_chunks, blk) int32).
    """
    if feats.device.type == "cpu":
        return occluders_plain(feats, w0b, rows, los, has, counts, data_t,
                               wide_t, blk=blk, w_sl=w_sl, k_occ=k_occ)
    _check_args(feats, w0b, rows, counts, data_t, wide_t,
                dict(los=los, has=has), {}, blk=blk, k_occ=k_occ)
    n_chunks = rows.shape[0]
    a12d = torch.empty((3 * k_occ, n_chunks * blk), dtype=torch.float32,
                       device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    err = _kernels.launch(
        feats.device, _kernels.load("occluders").occluders_a1,
        feats.data_ptr(), w0b.data_ptr(), rows.data_ptr(), los.data_ptr(),
        has.data_ptr(), counts.data_ptr(), data_t.data_ptr(),
        wide_t.data_ptr(), a12d.data_ptr(), ovf.data_ptr(),
        n_chunks, blk, w_sl, data_t.shape[2], wide_t.shape[2], k_occ,
        _stream(feats),
    )
    _kernels.check(err, "kernel A1 (occluders_a1)")
    find_occluders.launches += 1
    return a12d, ovf


def find_occluders_routed(feats, w0b, rows, los, gloa, mode, counts, data_t,
                          wide_t, *, blk: int, w_sl: int, k_occ: int,
                          band: int, group: int, wide_sl: int):
    """Span-routed phase A: kernel A2 on CUDA tensors, its plain version
    on CPU tensors. As `find_occluders`, with gloa (n_chunks * blk //
    group,) int32 per-group band starts and mode (n_chunks,) int32 (0 dead,
    1 full slice, 2 per-group band) in place of has."""
    kw = dict(blk=blk, w_sl=w_sl, k_occ=k_occ, band=band, group=group,
              wide_sl=wide_sl)
    if feats.device.type == "cpu":
        return occluders_routed_plain(feats, w0b, rows, los, gloa, mode,
                                      counts, data_t, wide_t, **kw)
    _check_args(feats, w0b, rows, counts, data_t, wide_t,
                dict(los=los, mode=mode), dict(gloa=gloa), blk=blk,
                k_occ=k_occ, group=group)
    if not 0 <= wide_sl <= wide_t.shape[2]:
        raise ValueError(f"wide_sl {wide_sl} outside 0..{wide_t.shape[2]}")
    n_chunks = rows.shape[0]
    a12d = torch.empty((3 * k_occ, n_chunks * blk), dtype=torch.float32,
                       device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    err = _kernels.launch(
        feats.device, _kernels.load("occluders").occluders_a2,
        feats.data_ptr(), w0b.data_ptr(), rows.data_ptr(), los.data_ptr(),
        gloa.data_ptr(), mode.data_ptr(), counts.data_ptr(),
        data_t.data_ptr(), wide_t.data_ptr(), a12d.data_ptr(),
        ovf.data_ptr(), n_chunks, blk, w_sl, data_t.shape[2],
        wide_t.shape[2], k_occ, band, group, wide_sl, _stream(feats),
    )
    _kernels.check(err, "kernel A2 (occluders_a2)")
    find_occluders_routed.launches += 1
    return a12d, ovf


def find_occluders_banded(feats, w0b, rows, gloa, glob, counts, data_t,
                          wide_t, *, blk: int, k_occ: int, band: int,
                          group: int, wide_sl: int, delta: float):
    """Dual-banded phase A: kernel A3 on CUDA tensors, its plain version
    on CPU tensors. gloa, glob (n_chunks * blk // group,) int32 are the
    per-group band starts; returns (a12d, ovf, unc) as
    `occluders_banded_plain`."""
    kw = dict(blk=blk, k_occ=k_occ, band=band, group=group, wide_sl=wide_sl,
              delta=delta)
    if feats.device.type == "cpu":
        return occluders_banded_plain(feats, w0b, rows, gloa, glob, counts,
                                      data_t, wide_t, **kw)
    _check_args(feats, w0b, rows, counts, data_t, wide_t, {},
                dict(gloa=gloa, glob=glob), blk=blk, k_occ=k_occ,
                group=group)
    if not 0 <= wide_sl <= wide_t.shape[2]:
        raise ValueError(f"wide_sl {wide_sl} outside 0..{wide_t.shape[2]}")
    n_chunks = rows.shape[0]
    dev = feats.device
    a12d = torch.empty((3 * k_occ, n_chunks * blk), dtype=torch.float32,
                       device=dev)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=dev)
    unc = torch.empty((n_chunks, blk), dtype=torch.int32, device=dev)
    err = _kernels.launch(
        dev, _kernels.load("occluders").occluders_a3,
        feats.data_ptr(), w0b.data_ptr(), rows.data_ptr(), gloa.data_ptr(),
        glob.data_ptr(), counts.data_ptr(), data_t.data_ptr(),
        wide_t.data_ptr(), a12d.data_ptr(), ovf.data_ptr(), unc.data_ptr(),
        n_chunks, blk, data_t.shape[2], wide_t.shape[2], wide_sl, k_occ,
        band, group, delta, _stream(feats),
    )
    _kernels.check(err, "kernel A3 (occluders_a3)")
    find_occluders_banded.launches += 1
    return a12d, ovf, unc


def _ungated_kernel(entry: str, what: str, feats, w0b, rows, los, counts,
                    data_t, wide_t, *, blk: int, w_sl: int, k_occ: int):
    """Launch `entry` (A4a or A4b) of csrc/occluders.cu on CUDA tensors."""
    _check_args(feats, w0b, rows, counts, data_t, wide_t, dict(los=los), {},
                blk=blk, k_occ=k_occ)
    n_chunks = rows.shape[0]
    a12d = torch.empty((3 * k_occ, n_chunks * blk), dtype=torch.float32,
                       device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    err = _kernels.launch(
        feats.device, getattr(_kernels.load("occluders"), entry),
        feats.data_ptr(), w0b.data_ptr(), rows.data_ptr(), los.data_ptr(),
        counts.data_ptr(), data_t.data_ptr(), wide_t.data_ptr(),
        a12d.data_ptr(), ovf.data_ptr(), n_chunks, blk, w_sl,
        data_t.shape[2], wide_t.shape[2], k_occ, _stream(feats),
    )
    _kernels.check(err, f"{what} ({entry})")
    return a12d, ovf


def occluders_ungated_plain(feats, w0b, rows, los, counts, data_t, wide_t,
                            *, blk: int, w_sl: int, k_occ: int):
    """Plain torch version of kernels A4a and A4b: A1's, `occluders_plain`,
    with every chunk live (the TPU kernels have no has gate)."""
    return occluders_plain(feats, w0b, rows, los,
                           torch.ones_like(rows, dtype=torch.int32), counts,
                           data_t, wide_t, blk=blk, w_sl=w_sl, k_occ=k_occ)


def find_occluders_t(feats, w0b, rows, los, counts, data_t, wide_t, *,
                     blk: int, w_sl: int, k_occ: int):
    """Phase A on kernel A4a (CUDA tensors) or on its plain version,
    `occluders_ungated_plain` (CPU tensors). Arguments and outputs as
    `find_occluders` without `has`."""
    if feats.device.type == "cpu":
        return occluders_ungated_plain(feats, w0b, rows, los, counts, data_t,
                                       wide_t, blk=blk, w_sl=w_sl,
                                       k_occ=k_occ)
    out = _ungated_kernel("occluders_a4a", "kernel A4a", feats, w0b, rows,
                          los, counts, data_t, wide_t, blk=blk, w_sl=w_sl,
                          k_occ=k_occ)
    find_occluders_t.launches += 1
    return out


def find_occluders_pair(feats, w0b, rows, los, counts, data_t, wide_t, *,
                        blk: int, w_sl: int, k_occ: int):
    """Phase A on kernel A4b (CUDA tensors) or on its plain version,
    `occluders_ungated_plain` (CPU tensors). As `find_occluders_t`; the
    chunk count must be even."""
    if rows.shape[0] % 2:
        raise ValueError(f"kernel A4b needs an even chunk count, got "
                         f"{rows.shape[0]}")
    if feats.device.type == "cpu":
        return occluders_ungated_plain(feats, w0b, rows, los, counts, data_t,
                                       wide_t, blk=blk, w_sl=w_sl,
                                       k_occ=k_occ)
    out = _ungated_kernel("occluders_a4b", "kernel A4b", feats, w0b, rows,
                          los, counts, data_t, wide_t, blk=blk, w_sl=w_sl,
                          k_occ=k_occ)
    find_occluders_pair.launches += 1
    return out


def find_occluders_folded(frame_args, *, blk: int, w_sl: int, k_occ: int):
    """A1 over B frames in one `find_occluders` call (the JAX package's
    `batch_fold` rule, pallas_occluders.py:1100-1119). `frame_args` holds B
    tuples of `find_occluders`' positional arguments of frames that share
    one bank (the first frame's counts, data_t and wide_t are read). The
    feature blocks are concatenated, each frame's
    w0b shifted by its block offset, rows/los/has flattened; the output
    splits back along the chunk axis. Returns B (a12d, ovf) pairs, each
    what `find_occluders` returns for that frame alone."""
    args, offsets = fold_args(frame_args, blk)
    a12d, ovf = find_occluders(*args, blk=blk, w_sl=w_sl, k_occ=k_occ)
    return list(zip(torch.split(a12d, [n * blk for n in offsets], dim=1),
                    torch.split(ovf, offsets, dim=0)))


def fold_args(frame_args, blk: int):
    """B frames' `find_occluders` arguments as one call's: (the folded
    arguments, each frame's chunk count)."""
    counts, data_t, wide_t = frame_args[0][5:]
    offsets, w0b, off = [], [], 0
    for args in frame_args:
        w0b.append(args[1] + off)
        offsets.append(args[2].shape[0])
        off += args[0].shape[0] // blk
    folded = (torch.cat([a[0] for a in frame_args]), torch.cat(w0b),
              *(torch.cat([a[i] for a in frame_args]) for i in (2, 3, 4)),
              counts, data_t, wide_t)
    return folded, offsets


WINDOW_FAR = 1e9   # the range of a window entry outside the point's window


def occluders_window_plain(xyz, row, lo, center, data_t, wide_t, ang_t,
                           wang_t, *, window_size: int, delta: float,
                           k_occ: int, beam_rad: float):
    """Plain torch version of kernel W1: the window assembly's occluders of
    P points (the JAX package's `_occluder_phase` on the candidates its
    `chunk_fn` gathers, models/snowfall.py:112-148, 356-368).

    Point i's candidates are bank columns lo[i] + j, j < window_size
    (clamped to the row's last column, so a window past the row's end
    repeats that column), of bank row row[i], then the row's n_wide wide
    columns (n_wide = wang_t.shape[2]). A window column whose sort angle
    lies outside [center - delta, center + delta] takes the range
    WINDOW_FAR, so it fails the range test, and keeps its index. The hit
    test is `candidate_intervals` on the columns' angles from the bank's
    tables ang_t and wang_t (`window_angles`), which kernel W1 reads too;
    the K nearest hits in lax.top_k's order (range, then candidate index).

    Returns occ_a1, occ_a2, occ_dist (P, K) f32, occ_valid (P, K) bool and
    occ_overflow (P,) int32, the hits beyond K. An empty slot holds a1 = a2
    = 0 and dist = inf (kernel W1 writes the same; the JAX package leaves
    the a1/a2 of whatever candidate top_k took there, which every consumer
    masks).
    """
    k_ext, n_wide = data_t.shape[2], wang_t.shape[2]
    if k_occ > window_size + n_wide:
        raise ValueError(f"max_occluders {k_occ} exceeds the "
                         f"{window_size + n_wide} candidates of a point")
    data = data_t[:, :4].transpose(1, 2)                 # (C, k_ext, 4)
    angle = data_t[:, SANG_ROW]
    wide = wide_t[:, :4, :n_wide].transpose(1, 2)        # (C, n_wide, 4)
    widx = (lo[:, None] + torch.arange(window_size, device=lo.device)
            ).clamp(0, k_ext - 1)
    wcand = data[row[:, None], widx]                     # (P, S, 4)
    wang = angle[row[:, None], widx]
    in_win = (wang >= (center - delta)[:, None]) & (
        wang <= (center + delta)[:, None])
    wcand = torch.cat([wcand[:, :, :3], torch.where(
        in_win, wcand[:, :, 3], WINDOW_FAR)[:, :, None]], dim=2)
    cand = torch.cat([wcand, wide[row]], dim=1)          # (P, S + W, 4)
    # (P, S + W, 3) pang, start, end: the columns' own values, so an
    # out-of-window column's interval is that of its true range (it never
    # hits, and an empty slot's a1/a2 are 0)
    ang = torch.cat([ang_t.transpose(1, 2)[row[:, None], widx],
                     wang_t.transpose(1, 2)[row]], dim=1)
    right, left = beam_limits(xyz[:, 0], xyz[:, 1], beam_rad)
    a1, a2, hit = candidate_intervals(
        right, left, cand[:, :, 0], cand[:, :, 1], cand[:, :, 2],
        cand[:, :, 3], torch.ones(cand.shape[:2], dtype=torch.bool,
                                  device=cand.device), norm3(xyz),
        angles=ang.unbind(2))
    occ_overflow = (hit.sum(dim=1) - k_occ).clamp_min(0).to(torch.int32)
    # lax.top_k's order: the nearest first, equal ranges by candidate index
    score = torch.where(hit, cand[:, :, 3], float("inf"))
    top, idx = torch.sort(score, dim=1, stable=True)
    top, idx = top[:, :k_occ], idx[:, :k_occ]
    valid = top < float("inf")
    return (torch.where(valid, a1.gather(1, idx), 0.0),
            torch.where(valid, a2.gather(1, idx), 0.0), top, valid,
            occ_overflow)


def window_angles(data_t, wide_t, n_wide: int):
    """The per-column angle tables of a bank that the window assembly
    reads (W1 and its plain version): (C, 3, k_ext) and (C, 3, n_wide) f32
    rows [pang, start, end] (`candidate_angles`) of the bank's columns and
    of its first n_wide wide columns, made with torch on the bank's device.
    They depend on the bank alone, so `models/snowfall.bank_to_torch` makes
    them once a bank."""
    def table(t):
        return torch.stack(candidate_angles(t[:, 0], t[:, 1], t[:, 2],
                                            t[:, 3]), dim=1).contiguous()

    return table(data_t), table(wide_t[:, :, :n_wide])


def find_occluders_window(xyz, row, lo, center, data_t, wide_t, ang_t,
                          wang_t, *, window_size: int, delta: float,
                          k_occ: int, beam_rad: float):
    """The window assembly's occluders of P points: kernel W1 on CUDA
    tensors, `occluders_window_plain` on CPU tensors. xyz (P, 3) f32, row
    and lo (P,) integer, center (P,) f32 (each point's signed azimuth),
    data_t (C, 8, k_ext) and wide_t (C, 8, wc) f32, ang_t (C, 3, k_ext) and
    wang_t (C, 3, n_wide) the bank's angle tables (`window_angles`).
    Returns what `occluders_window_plain` returns."""
    if xyz.device.type == "cpu":
        return occluders_window_plain(
            xyz, row, lo, center, data_t, wide_t, ang_t, wang_t,
            window_size=window_size, delta=delta, k_occ=k_occ,
            beam_rad=beam_rad)
    return launch_w1(w1_inputs(xyz, row, lo, center, data_t, wide_t, ang_t,
                               wang_t, delta=delta, beam_rad=beam_rad),
                     window_size=window_size, k_occ=k_occ)


def w1_inputs(xyz, row, lo, center, data_t, wide_t, ang_t, wang_t, *,
              delta: float, beam_rad: float) -> tuple:
    """Kernel W1's arrays, made by torch as `occluders_window_plain` makes
    its values: the point features (`point_features`), each point's window
    [center - delta, center + delta], row and lo as int32, the bank and its
    angle tables."""
    feats = point_features(xyz[:, 0], xyz[:, 1], xyz[:, 2],
                           beam_rad).contiguous()
    bounds = torch.stack([center - delta, center + delta], dim=1)
    return (feats, row.to(torch.int32), lo.to(torch.int32), bounds, data_t,
            wide_t, ang_t, wang_t)


def launch_w1(inputs: tuple, *, window_size: int, k_occ: int):
    """Launch kernel W1 on `w1_inputs`' arrays (CUDA tensors) and count
    the launch; returns (a1, a2, dist, valid, overflow)."""
    feats, row, lo, bounds, data_t, wide_t, ang_t, wang_t = inputs
    n = feats.shape[0]
    c_banks, _, k_ext = data_t.shape
    wc, n_wide = wide_t.shape[2], wang_t.shape[2]
    if not 0 < k_occ <= MAX_OCCLUDERS:
        raise ValueError(f"max_occluders {k_occ} outside 1..{MAX_OCCLUDERS}")
    if k_occ > window_size + n_wide or n_wide > wc:
        raise ValueError(f"max_occluders {k_occ} and n_wide {n_wide} do not "
                         f"fit window {window_size} + wide {wc}")
    check = _kernels.check_input
    check("feats", feats, torch.float32, (n, N_FEAT))
    check("row", row, torch.int32, (n,))
    check("lo", lo, torch.int32, (n,))
    check("bounds", bounds, torch.float32, (n, 2))
    check("data_t", data_t, torch.float32, (c_banks, 8, k_ext))
    check("wide_t", wide_t, torch.float32, (c_banks, 8, wc))
    check("ang_t", ang_t, torch.float32, (c_banks, 3, k_ext))
    check("wang_t", wang_t, torch.float32, (c_banks, 3, n_wide))
    dev = feats.device
    a1, a2, dist = (torch.empty((n, k_occ), dtype=torch.float32, device=dev)
                    for _ in range(3))
    valid = torch.empty((n, k_occ), dtype=torch.bool, device=dev)
    ovf = torch.empty(n, dtype=torch.int32, device=dev)
    err = _kernels.launch(
        dev, _kernels.load("occluders").occluders_w1,
        *(t.data_ptr() for t in inputs), a1.data_ptr(), a2.data_ptr(),
        dist.data_ptr(), valid.data_ptr(), ovf.data_ptr(), n, k_ext, wc,
        n_wide, window_size, k_occ, _stream(feats),
    )
    _kernels.check(err, "kernel W1 (occluders_w1)")
    find_occluders_window.launches += 1
    return a1, a2, dist, valid, ovf


find_occluders.launches = 0
find_occluders_window.launches = 0
find_occluders_routed.launches = 0
find_occluders_banded.launches = 0
find_occluders_t.launches = 0
find_occluders_pair.launches = 0
