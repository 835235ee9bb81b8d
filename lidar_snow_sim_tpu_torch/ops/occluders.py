"""Phase A of the dense snowfall assembly: the nearest K occluders of each
beam (counterpart of `lidar_snow_sim_tpu/ops/pallas_occluders.py`).

`find_occluders` launches kernel A1 (`csrc/occluders.cu`) on CUDA tensors
and runs `occluders_plain`, the same function in plain torch, on CPU
tensors. Both follow the arithmetic of the TPU kernel `_kernel`
(pallas_occluders.py:150): an exact hit test of every beam of a chunk
against one bank slice plus the row's wide list, then the K nearest hits
in lax.top_k order (ascending range, ties to the lowest column).

Point-feature rows (`point_features`): [d_orig, right, left, sin_r, cos_r,
sin_l, cos_l, wrapped_beam, signed azimuth]. Bank property rows
(ParticleBank.data_t / wide_t): [x, y, r, dist, azimuth in [0, 2pi),
half-width, signed sort angle, 0].

Outputs: a12d (3K, n_chunks * blk) holding [a1; a2; dist], K outer, with
a1 = a2 = 0 and dist = 3e38 in empty slots (the TPU kernel leaves a retired
column's a1/a2 there, so compare a1/a2 only where dist < 1e37), and the
per-beam overflow max(n_hit - K, 0) as (n_chunks, blk) int32. Dead chunks
(`has == 0`) hold the empty-slot sentinels and zero overflow.
"""

from __future__ import annotations

import torch

from lidar_snow_sim_tpu_torch import _kernels
from lidar_snow_sim_tpu_torch.ops.geometry import TWO_PI, beam_limits

BIG = 3.0e38
N_FEAT = 9
MAX_OCCLUDERS = 512   # largest K the kernel's per-thread list is built for
_GROUP = 32           # chunks per step of the plain version (bounds memory)


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


def occluders_plain(feats, w0b, rows, los, has, counts, data_t, wide_t, *,
                    blk: int, w_sl: int, k_occ: int):
    """Plain torch version of kernel A1, _GROUP live chunks at a time."""
    n_chunks = rows.shape[0]
    k_ext = data_t.shape[2]
    dev = feats.device
    props = data_t.permute(0, 2, 1)                    # (C, k_ext, 8)
    wide = wide_t.permute(0, 2, 1)                     # (C, wc, 8)
    fb = feats.reshape(-1, blk, N_FEAT)
    # [a1; a2; dist] planes start as the empty-slot sentinels, which is
    # all a dead chunk holds
    a12d = torch.zeros((3, k_occ, n_chunks, blk), dtype=torch.float32,
                       device=dev)
    a12d[2] = BIG
    ovf = torch.zeros((n_chunks, blk), dtype=torch.int32, device=dev)
    offs = torch.arange(w_sl, device=dev)
    live = torch.nonzero(has).flatten()
    for g0 in range(0, live.shape[0], _GROUP):
        sl = live[g0:g0 + _GROUP]
        row = rows[sl].long()
        f = fb[w0b[sl].long()]                          # (G, blk, 9)
        cols = los[sl].long()[:, None] + offs[None, :]  # (G, w_sl)
        cand = torch.cat(
            [props[row[:, None], cols.clamp(max=k_ext - 1)], wide[row]], dim=1
        )                                               # (G, Ct, 8)
        # wrap-pad dedup (a slice column at or past the row's narrow count
        # repeats an earlier particle) and the end of the bank row
        col_ok = torch.cat(
            [
                (cols < k_ext) & (offs[None, :] < counts[row].long()[:, None]),
                torch.ones((row.shape[0], wide.shape[1]), dtype=torch.bool,
                           device=dev),
            ],
            dim=1,
        )
        px, py, pr, pdist, pang, halfw = (
            cand[:, None, :, i] for i in range(6)
        )                                               # (G, 1, Ct)
        d_orig, right, left, sin_r, cos_r, sin_l, cos_l = (
            f[:, :, i:i + 1] for i in range(7)
        )                                               # (G, blk, 1)
        wrapped = f[:, :, 7:8] > 0.5

        center_in = (right <= pang) & (pang <= left)
        center_in |= wrapped & (right - TWO_PI <= pang) & (pang <= left)
        center_in |= wrapped & (right <= pang) & (pang <= left + TWO_PI)
        dist_r = torch.abs(px * sin_r - py * cos_r)
        dist_l = torch.abs(px * sin_l - py * cos_l)
        right_hit = (dist_r < pr) & (cos_r * px + sin_r * py > 0)
        left_hit = (dist_l < pr) & (cos_l * px + sin_l * py > 0)
        hit = (center_in | right_hit | left_hit) & (pdist < d_orig)
        hit &= col_ok[:, None, :]

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
            val,                                        # BIG where empty
        ])                                              # (3, G, blk, k_have)
        a12d[:, :k_have, sl] = top.permute(0, 3, 1, 2)
        ovf[sl] = (n_hit - k_occ).clamp_min(0).to(torch.int32)
    return a12d.reshape(3 * k_occ, n_chunks * blk), ovf


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
    n_chunks = rows.shape[0]
    c_banks, _, k_ext = data_t.shape
    if not 0 < k_occ <= MAX_OCCLUDERS:
        raise ValueError(f"max_occluders {k_occ} outside 1..{MAX_OCCLUDERS}")
    if not 0 < blk <= 1024 or feats.shape[0] % blk:
        raise ValueError(f"block_points {blk} must divide {feats.shape[0]} "
                         "and be at most 1024")
    check = _kernels.check_input
    check("feats", feats, torch.float32, (feats.shape[0], N_FEAT))
    for name, t in (("w0b", w0b), ("rows", rows), ("los", los),
                    ("has", has)):
        check(name, t, torch.int32, (n_chunks,))
    check("counts", counts, torch.int32, (c_banks,))
    check("data_t", data_t, torch.float32, (c_banks, 8, k_ext))
    check("wide_t", wide_t, torch.float32, (c_banks, 8, wide_t.shape[2]))
    a12d = torch.empty((3 * k_occ, n_chunks * blk), dtype=torch.float32,
                       device=feats.device)
    ovf = torch.empty((n_chunks, blk), dtype=torch.int32, device=feats.device)
    lib = _kernels.load("occluders")
    err = lib.occluders_a1(
        feats.data_ptr(), w0b.data_ptr(), rows.data_ptr(), los.data_ptr(),
        has.data_ptr(), counts.data_ptr(), data_t.data_ptr(),
        wide_t.data_ptr(), a12d.data_ptr(), ovf.data_ptr(),
        n_chunks, blk, w_sl, k_ext, wide_t.shape[2], k_occ,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    _kernels.check(err, "kernel A1 (occluders_a1)")
    find_occluders.launches += 1
    return a12d, ovf


find_occluders.launches = 0
