"""Device-resident pitch tracking: the analysis -> render control path on the
card, with no host round trip of the peaks or of the slot table.

The host pitch pipeline (analysis/pitch.py, native/pitchpipe.cpp) moves the
(frames, k) peaks to the host and the slot control table back. Here the
tracker is device code:

  * frame-local stages (pitch conversion, nearby-peak aggregation,
    reduction, perceived-loudness ordering) are batched over all frames;
    aggregation's greedy grouping is the orbit of lane 0 under the "first
    lane beyond my group" map, found by pointer doubling;
  * the cross-frame state machine is FRAME-PARALLEL
    (`_build_tables_parallel`): absent voice-cap drops the played set
    entering frame f is exactly frame f-1's valid tuned pitches, so the
    reference's two-pointer matching (rt.resynth.lib.algo.cpp:256-305)
    becomes a per-frame-pair batch, note identity becomes pointer doubling
    over match links, and the per-voice phase/volume boundary recurrences
    become carried modular sums / affine compositions in the same doubling.
    An exact violation predicate (cap drop possible, slot overflow, overlong
    release tail) sends the call to the faithful frame loop (`_track_step`);
  * both paths emit the SAME (total_frames, n_slots, 16) control table the
    host builders produce (models/resynth_bank.py field order);
  * which path runs depends on the lanes' device
    (`_tries_frame_parallel`): on the card the frame loop is one launch of a
    CUDA kernel for every job and never synchronises, so it builds every
    table (the kernel's wrapper refuses a shape it does not take); the
    frame-parallel try, its flag read and the loop on a violation serve
    the CPU.

Port of cpp_audio_tpu/analysis/device_tracker.py: the float32 serving path
(:1-1201), and the fidelity chain's tracker (the df32 tracker, :1204-2126)
as this same code at float64 (`build_tables_device_df`). What the TPU shaped
and the port does not keep: every one-hot contraction that stood in for a
gather or a scatter is a gather, a scatter or a min/max scatter-reduce
(exact: each target is unique, or the reduction is order-free); the float
group sums stay one-hot contractions (`_group_sum`), so the card adds them
in a fixed order and gives the same table on every run; the boolean matrix
squaring of the jump graph is pointer doubling of the jump map; `lax.cond`
on the violation flag reads that one flag on the host (counted in
HOST_SYNCS) and runs one branch, where the frame-parallel path is tried;
`lax.scan` over frames is a Python loop on the CPU (`_scan_tables_plain`)
and, on the card, one launch of a CUDA kernel for every job of the call
(ops/cuda_scan).
`.at[i].set(..., mode="drop")` writes go through a spare row that is
sliced off (or, for per-slot state, kept as row P and never read), so the
only duplicate targets are that spare row. The working dtype follows the
peaks: float32 on the serving path, float64 in the fidelity chain.

Semantics match PitchTracker/native pitchpipe exactly for the supported
config subset, as in the JAX package (see its module docstring).
Reference: RtResynth::step pipeline (source/rt.resynth.lib.cpp:1670-1759),
synthesize_sounds event policy (:265-382).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import cuda_scan
from ..utils import profiling

FAR = 1e12
_FAR32 = float(np.float32(FAR))  # the parallel tracker's np.float32(FAR)
_PITCH_EPSILON = 1e-4  # rt.resynth.lib.algo.cpp:3
_NF = 16
(_F_INC, _F_RATIO, _F_PHB, _F_VTGT, _F_VB, _F_ALPHA, _F_TP0, _F_TR0,
 _F_TOP, _F_A, _F_H, _F_D, _F_SUS, _F_R, _F_GL, _F_GR) = range(_NF)
# table row of a slot that plays nothing
_DEFAULT_ROW = ((_F_INC, 1e-6), (_F_TP0, -1e9), (_F_A, 1.0), (_F_SUS, 1.0),
                (_F_R, 1.0))
# per-slot float state of the frame loop (columns of its (P + 1, 14) table)
(_S_PRESS, _S_RELEASE, _S_TOP, _S_A, _S_H, _S_D, _S_R, _S_GL, _S_GR,
 _S_PHASE, _S_VOLB, _S_PREVINC, _S_CURINC, _S_CURVOL) = range(14)
_Q = 128  # played-set capacity (_keywords caps max_voices at 127)

# Host synchronisations made by the tracker: one read of the violation flag
# per tracker call (_tables) that tries the frame-parallel path (none on the
# card where the frame-loop kernel takes the call).
HOST_SYNCS = 0
# Tables built by the exact frame loop (_scan_tables), one per job.
FRAME_LOOPS = 0
# Host arrays copied to the device inside a chain step: the vocoder's
# per-call kernel matrix and interpolation tables (analysis/vocoder.py).
H2D_COPIES = 0
# what a span records the change of (utils/profiling.span): the step's
# waits for the device (flag reads and copies from host memory), the
# frame loops
profiling.COUNTERS["host_waits"] = lambda: HOST_SYNCS + H2D_COPIES
profiling.COUNTERS["frame_loops"] = lambda: FRAME_LOOPS


def _pitch_of_freq(freq):
    return 69.0 + 12.0 * torch.log2(freq / 440.0)


def _freq_of_pitch(pitch):
    return 440.0 * torch.exp2((pitch - 69.0) / 12.0)


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def _cst(x: float, dtype: torch.dtype) -> float:
    """x rounded to the working dtype (the JAX package's np.asarray(x, wdt))."""
    return float(np.asarray(x, _np_dtype(dtype)))


def _sort_by(key, *carried):
    """jax.lax.sort((key, *carried), num_keys=1) along the last axis: a
    stable sort of `key` carrying the other operands."""
    order = torch.sort(key, dim=-1, stable=True).indices
    return tuple(torch.gather(a, -1, order) for a in (key,) + carried)


def _group_sum(gid, vals, n_groups: int):
    """out[f, g] = the sum of vals[f, j] over the lanes j with gid[f, j] ==
    g, for (F, k) gid and vals; a lane whose gid lies outside [0, n_groups)
    adds nothing. The JAX package's one-hot contraction: a reduction over
    the lane axis of the (F, k, n_groups) masked values, whose association
    the shapes fix, so the card gives the same sums on every run (a float
    scatter_add adds in the order its atomics land). Groups are contiguous
    runs of lanes, so a segmented sum would do too, but only through a
    cumsum and a difference, which rounds each group by the running total
    before it. The price is memory: a bool mask and a values tensor of
    (F, k, n_groups) each, O(F k^2) with n_groups = k. F counts every row:
    build_tables_device_batch passes batch x frames rows, and each harmonize
    stage doubles the k of the sums after it (chip_smoke.py's
    `[tracker memory]` line measures the stage's peak)."""
    member = gid[..., None] == torch.arange(n_groups, device=gid.device)
    return torch.where(member, vals[..., None], vals.new_zeros(())).sum(dim=1)


def _set_drop(arr, idx, vals):
    """arr.at[idx].set(vals, mode="drop") for a 1-D arr whose only
    out-of-range index is len(arr): write through a spare row."""
    ext = torch.cat([arr, arr[:1]])
    if torch.is_tensor(vals):
        ext[idx] = vals
    else:  # a Python scalar, filled on the device (no host copy)
        ext.index_fill_(0, idx, vals)
    return ext[:-1]


def _default_row(dtype, device):
    row = torch.zeros(_NF, dtype=dtype, device=device)
    for field, value in _DEFAULT_ROW:
        # fill_ of a slice: assigning a scalar to row[field] copies it from
        # the host, a synchronisation on a CUDA tensor
        row.narrow(0, field, 1).fill_(value)
    return row


def _harmonize_lanes(tpitch, tvol, h: float):
    """Device harmonize_pitches (rt.resynth.lib.algo.cpp:318-371), MERGED
    semantics: add a +h-halftones copy of every pitch; a copy within
    PITCH_EPSILON of an existing pitch merges its volume into the true
    closest original instead. (F, k) -> (F, 2k), re-sorted ascending with
    inf padding. See the JAX package's docstring for where this differs
    from the reference's probe semantics (`_harmonize_lanes_reference`)."""
    F, k = tpitch.shape
    valid = torch.isfinite(tpitch)
    hp = torch.where(valid, tpitch + h, torch.inf)
    # |original_j - copy_i|, invalid originals pushed to +inf
    pj = torch.where(valid, tpitch, FAR)[:, None, :]
    dist = torch.abs(pj - torch.where(valid, hp, -FAR)[:, :, None])  # (F, i, j)
    mind = dist.min(dim=-1).values
    merge = valid & (mind <= _PITCH_EPSILON)
    # first (lowest-j) original attaining the min — reference std::min_element
    lane = torch.arange(k, device=tpitch.device)
    first_j = torch.where(dist <= mind[..., None], lane, k).min(dim=-1).values
    vol_add = _group_sum(torch.where(merge, first_j, k), tvol, k)
    keep = valid & ~merge
    cat_p = torch.cat([tpitch, torch.where(keep, hp, torch.inf)], dim=-1)
    cat_v = torch.cat([tvol + vol_add, torch.where(keep, tvol, 0.0)], dim=-1)
    key = torch.where(torch.isfinite(cat_p), cat_p, torch.inf)
    _, out_p, out_v = _sort_by(key, cat_p, cat_v)
    return out_p, out_v


def _harmonize_lanes_reference(tpitch, tvol, h: float):
    """Device harmonize_pitches with the reference's PROBE-EXACT semantics
    (rt.resynth.lib.algo.cpp:318-371, find_closest_pitch at
    rt.resynth.lib.autotune.cpp:189-218): for each original pitch i in
    ascending order, probe the GROWING vector with std::lower_bound's exact
    midpoint sequence, merge the copy's volume into the probed element when
    within PITCH_EPSILON, else append it. Matches
    analysis/pitch.harmonize_pitches(semantics="reference") exactly.

    Sequential by construction: a loop over the k original lanes with a
    fixed-iteration binary search (gathers), batched over frames.
    (F, k) sorted pitches (+inf pad) -> (F, 2k) sorted, stable."""
    F, k = tpitch.shape
    dev = tpitch.device
    n2 = 2 * k
    valid = torch.isfinite(tpitch)
    sz = valid.sum(dim=-1)                                   # (F,)
    ap = torch.cat([torch.where(valid, tpitch, torch.inf),
                    tpitch.new_full((F, k), torch.inf)], dim=-1)
    av = torch.cat([torch.where(valid, tvol, 0.0), tvol.new_zeros((F, k))],
                   dim=-1)
    cnt = sz.clone()
    lanes = torch.arange(n2, device=dev)
    n_iter = int(np.ceil(np.log2(n2 + 1)))

    def gather(arr, idx):
        # the JAX form reads 0 out of range; every such read here is masked
        return torch.gather(arr, 1, idx.clamp(0, n2 - 1)[:, None])[:, 0]

    for i in range(k):
        active = i < sz                                      # (F,)
        hp = ap[:, i] + h
        # std::lower_bound midpoint trace over [0, cnt)
        lo = torch.zeros_like(cnt)
        hi = cnt
        for _ in range(n_iter):
            cond = lo < hi
            mid = (lo + hi) // 2
            less = gather(ap, mid) < hp
            lo = torch.where(cond & less, mid + 1, lo)
            hi = torch.where(cond & ~less, mid, hi)
        # find_closest_pitch neighbor comparison
        at_end = lo >= cnt
        at_beg = lo == 0
        d_lo = torch.abs(hp - gather(ap, torch.minimum(lo, cnt - 1)))
        d_prev = torch.abs(hp - gather(ap, torch.clamp(lo - 1, min=0)))
        idx = torch.where(at_end, cnt - 1,
                          torch.where(at_beg, 0,
                                      torch.where(d_lo < d_prev, lo, lo - 1)))
        merge = (torch.abs(gather(ap, idx) - hp) <= _PITCH_EPSILON) & active
        append = ~merge & active
        pvol = av[:, i]  # CURRENT volume (post-merge aliasing)
        at_idx = lanes[None, :] == idx[:, None]
        av = av + torch.where(merge[:, None] & at_idx, pvol[:, None], 0.0)
        at_cnt = append[:, None] & (lanes[None, :] == cnt[:, None])
        ap = torch.where(at_cnt, hp[:, None], ap)
        av = torch.where(at_cnt, pvol[:, None], av)
        cnt = cnt + append.to(cnt.dtype)
    key = torch.where(torch.isfinite(ap), ap, torch.inf)
    _, out_p, out_v = _sort_by(key, ap, av)
    return out_p, out_v


def _autotune_lanes(tpitch, tvol, at_root, at_scale, at_equid, at_allowed, *,
                    kind: str, max_pitch: float, tolerance: float):
    """Device autotune_pitches (rt.resynth.lib.algo.cpp:191-229 +
    autotune.cpp:89-142): snap each pitch to the allowed set, keep the
    original when it (or its snap) exceeds max_pitch, drop entries farther
    than `tolerance` from their snap, merge coincident outputs (within
    PITCH_EPSILON — exact for snapped values, which land on a discrete grid).
    """
    valid = torch.isfinite(tpitch)
    p = torch.where(valid, tpitch, 0.0)
    if kind == "scale":
        # octave-folded closest scale degree (MusicalScalePitches::
        # closest_pitch, autotune.cpp:89-142; int() truncation replicated)
        od = (p - at_root) / 12.0
        oct_t = torch.where(od >= 0, torch.trunc(od), torch.trunc(od) - 1.0)
        rel = p - oct_t * 12.0 - at_root
        idx = (rel[..., None] >= at_equid).sum(dim=-1)
        snap = at_scale[idx]
        tp = p - (rel - snap)
    else:  # "allowed": closest element of a sorted list, ties -> lower
        if at_allowed.shape[0] == 0:
            return torch.full_like(tpitch, torch.inf), torch.zeros_like(tvol)
        dist = torch.abs(p[..., None] - at_allowed)
        mind = dist.min(dim=-1).values
        tp = torch.where(dist <= mind[..., None], at_allowed,
                         torch.inf).min(dim=-1).values
    use_tp = (p <= max_pitch) & (tp <= max_pitch)
    snapped = torch.where(use_tp, tp, p)
    keep = valid & (torch.abs(snapped - p) <= tolerance)
    out_p = torch.where(keep, snapped, torch.inf)
    out_v = torch.where(keep, tvol, 0.0)
    # merge coincident consecutive outputs: sort, then group within eps
    sp, sv = _sort_by(out_p, out_v)
    fin = torch.isfinite(sp)
    prev = torch.cat([torch.full_like(sp[:, :1], -torch.inf), sp[:, :-1]],
                     dim=-1)
    boundary = ~fin | (sp - prev >= _PITCH_EPSILON)
    gid = torch.cumsum(boundary.to(torch.int64), dim=-1) - 1
    gvol = _group_sum(gid, torch.where(fin, sv, 0.0), sv.shape[-1])
    gp = torch.full_like(sp, torch.inf).scatter_reduce_(
        1, gid, torch.where(fin, sp, torch.inf), "amin")
    return gp, torch.where(torch.isfinite(gp), gvol, 0.0)


def _group_ids(pitch, valid, d: float):
    """Greedy nearby grouping (rt.resynth.lib.algo.cpp:124-184): (F, k)
    group id of every lane. Lane j starts a group iff it lies on the orbit
    of lane 0 under nxt (the first lane beyond the group a lane opens);
    the orbit is found by pointer doubling of nxt, the same boundaries the
    JAX package finds by squaring the jump graph's 0/1 matrix."""
    F, k = pitch.shape
    # first lane beyond the group lane i would open; k = past the end
    nxt = ((pitch[:, None, :] <= pitch[:, :, None] + d)
           & valid[:, None, :]).sum(dim=-1)
    reach = torch.zeros((F, k + 1), dtype=torch.bool, device=pitch.device)
    reach[:, 0] = True
    ones = torch.ones((F, k), dtype=torch.int32, device=pitch.device)
    past_end = nxt.new_full((F, 1), k)
    for _ in range(max(1, int(np.ceil(np.log2(k))))):
        # lanes reachable in one jump (of the current length) from reach
        hit = torch.zeros((F, k + 1), dtype=torch.int32, device=pitch.device)
        hit.scatter_add_(1, torch.where(reach[:, :k], nxt, k), ones)
        reach = reach | (hit > 0)
        nxt = torch.gather(torch.cat([nxt, past_end], dim=1), 1, nxt)
    return torch.cumsum(reach[:, :k].to(torch.int64), dim=-1) - 1


def valid_peaks(freq, mag_db):
    """(F, k) bool: the peaks with a finite magnitude and a finite, positive
    frequency."""
    return torch.isfinite(mag_db) & (freq > 0) & torch.isfinite(freq)


def _frame_local(freq, mag_db, loud_pitches, loud_spl, at_root, at_scale,
                 at_equid, at_allowed, *, d: float, min_volume: float,
                 pitch_method: int, volume_method: int, shift_pre: float,
                 shift_post: float, analysis_volume: float,
                 harmonize_pre: float = 0.0, harmonize_post: float = 0.0,
                 autotune_kind: str = "off",
                 autotune_max_pitch: float = 150.0,
                 autotune_tolerance: float = 100.0,
                 harmonize_semantics: str = "merged"):
    """Batched frame-local pipeline: peaks -> (tuned pitch, volume, order),
    running the reference stage order shift(pre) -> harmonize(pre) ->
    autotune -> shift(post) -> harmonize(post)
    (RtResynth::step, rt.resynth.lib.cpp:1676-1727).

    freq/mag_db: (F, k) frequency-sorted peak arrays (-inf mag = invalid).
    Returns (F, k') tuned pitch (+inf pad), volume (0 pad), loudness order —
    k' doubles per enabled harmonize stage.
    """
    valid = valid_peaks(freq, mag_db)
    pitch = torch.where(valid, _pitch_of_freq(torch.clamp(freq, min=1e-9)),
                        torch.inf)
    vol = torch.where(valid, torch.pow(10.0, mag_db / 20.0), 0.0)

    gid = _group_ids(pitch, valid, d)
    k = pitch.shape[-1]
    sum_vol = _group_sum(gid, vol, k)
    sum_pv = _group_sum(gid, torch.where(valid, pitch, 0.0) * vol, k)
    count = _group_sum(gid, valid.to(torch.int64), k)  # integer: exact
    zero = torch.zeros_like(pitch)
    max_vol = zero.scatter_reduce(1, gid, vol, "amax")
    p_in = torch.where(valid, pitch, torch.inf)
    min_p = torch.full_like(pitch, torch.inf).scatter_reduce(1, gid, p_in, "amin")
    max_p = torch.full_like(pitch, -torch.inf).scatter_reduce(
        1, gid, torch.where(valid, pitch, -torch.inf), "amax")
    # first (lowest-pitch) element attaining the group max volume
    is_max = vol >= torch.gather(max_vol, 1, gid)
    pitch_at_max = torch.full_like(pitch, torch.inf).scatter_reduce(
        1, gid, torch.where(is_max, p_in, torch.inf), "amin")

    gvol = max_vol if volume_method == 0 else sum_vol  # MAX_VOLUME | SUM
    if pitch_method == 0:  # INTERVAL_CENTER
        gpitch = 0.5 * (min_p + max_p)
    elif pitch_method == 1:  # MAX_VOLUME
        gpitch = pitch_at_max
    else:  # PONDERATE_BY_VOLUME
        gpitch = sum_pv / torch.clamp(sum_vol, min=1e-30)
    keep = (gvol >= min_volume) & (count > 0)

    tpitch, tvol = _sort_by(torch.where(keep, gpitch + shift_pre, torch.inf),
                            torch.where(keep, gvol, 0.0))
    hfn = (_harmonize_lanes_reference if harmonize_semantics == "reference"
           else _harmonize_lanes)
    if harmonize_pre:
        tpitch, tvol = hfn(tpitch, tvol, harmonize_pre)
    if autotune_kind != "off":
        tpitch, tvol = _autotune_lanes(
            tpitch, tvol, at_root, at_scale, at_equid, at_allowed,
            kind=autotune_kind, max_pitch=autotune_max_pitch,
            tolerance=autotune_tolerance)
    if shift_post:
        tpitch = torch.where(torch.isfinite(tpitch), tpitch + shift_post,
                             tpitch)
    if harmonize_post:
        tpitch, tvol = hfn(tpitch, tvol, harmonize_post)

    # perceived-loudness order (60 phon): stable descending vol/loudness,
    # interpolated over the 29-point ISO table
    x = torch.where(torch.isfinite(tpitch), tpitch, loud_pitches[-1])
    x = torch.minimum(torch.maximum(x, loud_pitches[0]), loud_pitches[-1])
    nlp = loud_pitches.shape[0]
    seg = torch.clamp((x[..., None] >= loud_pitches).sum(dim=-1) - 1,
                      0, nlp - 2)
    x0, x1 = loud_pitches[seg], loud_pitches[seg + 1]
    y0, y1 = loud_spl[seg], loud_spl[seg + 1]
    tfr = torch.where(x1 > x0, (x - x0) / torch.clamp(x1 - x0, min=1e-30), 0.0)
    spl = y0 + tfr * (y1 - y0)
    # padded lanes carry w = 0 (-w = -0.0 for all of them; no +0.0 key, so
    # torch's -0.0 == 0.0 gives the same stable order as JAX's total order)
    w = tvol / spl
    loud_order = torch.argsort(-w, dim=-1, stable=True)
    return tpitch, analysis_volume * tvol, loud_order


def _two_pointer(lb, ub, Q: int):
    """The reference's two-pointer matching loop (algo.cpp:256-305) as the
    integer recurrence c_j = max(it_j, lb_j); matched_j = c_j < ub_j;
    it_{j+1} = c_j + matched_j, for (N, k) rows of played-index windows.
    Evaluated carry-lookahead style as in the JAX package: blocks of 8
    lanes tabulate their composed pointer map over all Q+1 pointer values,
    block carries chain through gathers, then every block resolves its
    lanes. Returns (c, matched), each (N, k)."""
    N, k = lb.shape
    B = 8
    assert k % B == 0, "tracker lane count must be a multiple of 8"
    nb = k // B
    lb2 = lb.reshape(N, nb, B)
    ub2 = ub.reshape(N, nb, B)
    v = torch.arange(Q + 1, device=lb.device).expand(N, nb, Q + 1)
    for i in range(B):
        c = torch.maximum(v, lb2[:, :, i:i + 1])
        v = c + (c < ub2[:, :, i:i + 1])
    x = lb.new_zeros((N,))
    xs_in = []
    for b in range(nb):
        xs_in.append(x)
        x = torch.gather(v[:, b, :], 1, x.clamp(0, Q)[:, None])[:, 0]
    vv = torch.stack(xs_in, dim=1)  # (N, nb)
    cs_cols, m_cols = [], []
    for i in range(B):
        c = torch.maximum(vv, lb2[:, :, i])
        m = c < ub2[:, :, i]
        cs_cols.append(c)
        m_cols.append(m)
        vv = c + m
    return (torch.stack(cs_cols, dim=-1).reshape(N, k),
            torch.stack(m_cols, dim=-1).reshape(N, k))


def _match_parallel(tpitch, tvalid, maxd, Q: int):
    """Per-frame two-pointer matching f-1 -> f, batched over ALL frames.

    Valid when the played set before frame f equals frame f-1's valid tuned
    pitches (no voice-cap drops, min_volume > 0) — the violation predicate,
    which _tables reads, guards this. Returns (matched, match_prev) (F, k).
    """
    k = tpitch.shape[1]
    prev = torch.cat([tpitch.new_full((1, k), torch.inf), tpitch[:-1]], dim=0)
    # rows are ascending (+inf padded): searchsorted counts exactly what the
    # JAX package's compare-all sums count
    lb = torch.searchsorted(prev, (tpitch - maxd).contiguous())
    ub = torch.searchsorted(prev, (tpitch + maxd).contiguous(), right=True)
    cs, matched = _two_pointer(lb, torch.where(tvalid, ub, -1), Q)
    return matched, torch.where(matched, cs, 0)


def _build_tables_parallel(tpitch, volume, loud_order, is_data, pan_draws,
                           phase_draws, defaults, *, S, sr, maxd, max_voices,
                           P, Q, attack, hold, decay, sustain, release,
                           stereo_spread, total_frames, t_max, tail_E=16,
                           stable_draws: bool = False):
    """Frame-PARALLEL tracker: same table as the `_track_step` loop, built
    from batched (F, k) tensor ops (no per-frame loop).

    The cross-frame recurrence collapses because, absent voice-cap drops, the
    played set entering frame f is exactly frame f-1's valid tuned pitches:
    matching becomes frame-local (batched two-pointer), note identity becomes
    pointer-doubling over match links, and the per-voice phase/volume boundary
    recurrences become carried sums/affine compositions in the same doubling.
    Returns (table, violation) — `violation` (a 0-d bool tensor) True means
    an assumption broke (cap drop possible, slot-table overflow, release
    tail longer than t_max) and the caller must use the frame loop instead.
    """
    F, k = tpitch.shape
    dev = tpitch.device
    f32 = tpitch.dtype  # working dtype (the JAX package's name for it)
    cst = lambda x: _cst(x, f32)  # noqa: E731
    S32 = float(np.float32(S))
    min_dt = sr / 1000.0
    has_decay = sustain < 0.999999
    sus = min(max(sustain, 0.0), 1.0) if has_decay else 1.0
    attack_eff = cst(max(attack, min_dt, 1.0))
    decay_eff = cst(max(decay, min_dt, 1.0))
    release_eff = cst(max(release, min_dt, 1.0))
    hold_eff = cst(max(hold, 0.0))

    tvalid = torch.isfinite(tpitch) & is_data[:, None]
    viol = torch.any(tvalid.sum(dim=-1) > max_voices)
    viol = viol | torch.any(tvalid & ~(volume > 0))

    matched, match_prev = _match_parallel(tpitch, tvalid, maxd, Q)
    alive = tvalid
    f_iota = torch.arange(F, device=dev)[:, None]
    lane_iota = torch.arange(k, device=dev).expand(F, k)

    def lane_take(idx, stack):
        """stack (F, k, C); idx (F, k) lane ids -> stack[f, idx[f, i], :]."""
        return torch.gather(stack, 1, idx[..., None].expand(F, k, stack.shape[-1]))

    fin = lambda a: torch.where(torch.isfinite(a), a, 0.0)  # noqa: E731

    # per-lane local values
    inc_to = 2.0 * _freq_of_pitch(tpitch) / sr
    prev_inc = torch.cat([inc_to[:1], inc_to[:-1]], dim=0)
    inc_from = torch.where(matched, lane_take(match_prev, fin(prev_inc)[..., None])[..., 0],
                           inc_to)
    ratio = torch.where(inc_to == inc_from, 0.0,
                        torch.log(torch.clamp(inc_to, min=1e-30)
                                  / torch.clamp(inc_from, min=1e-30)))
    alpha = 1.0 - torch.exp(-math.pi * torch.clamp(torch.abs(inc_to),
                                                   max=float(np.float32(2.0 / S))))
    lam = ratio / S32
    dphi_loc = torch.where(ratio == 0.0, S32 * inc_from,
                           inc_from / torch.where(lam == 0, 1.0, lam)
                           * torch.expm1(ratio))
    q_loc = torch.pow(1.0 - alpha, S32)
    c_loc = volume
    b_loc = (1.0 - q_loc) * c_loc

    # birth-lane values (as if every lane were a birth; gathered later)
    min_change = torch.floor(0.5 + 2.5 * 2.0
                             / torch.clamp(torch.abs(inc_to), min=1e-9))
    A_b = torch.clamp(torch.clamp(min_change, min=attack_eff), min=1.0)
    D_b = (torch.clamp(torch.clamp(min_change, min=decay_eff), min=1.0)
           if has_decay else torch.zeros_like(A_b))
    R_b = torch.clamp(torch.clamp(min_change, min=release_eff), min=1.0)
    on_mask = tvalid & ~matched & (volume > 0)
    on_l = torch.gather(on_mask, 1, loud_order)
    r_l = torch.cumsum(on_l, dim=-1) - 1
    rank_p = torch.empty_like(r_l).scatter_(1, loud_order, r_l)  # permutation
    n_ons = on_l.sum(dim=-1)
    if stable_draws:
        # position-keyed: frame * max_voices + on-rank (see _track_step)
        base = torch.arange(F, device=dev) * max_voices
    else:
        base = torch.cumsum(n_ons, dim=0) - n_ons
    draw_idx = base[:, None] + rank_p
    pools = torch.stack([pan_draws[:phase_draws.shape[0]],
                         phase_draws[:pan_draws.shape[0]]], dim=-1)
    got_draws = pools[draw_idx.clamp(0, pools.shape[0] - 1)]
    pan = cst(stereo_spread) * got_draws[..., 0]
    th = cst(0.25 * np.pi) * (pan + 1.0)
    gl_b = torch.cos(th)
    gr_b = torch.sin(th)
    ph0_b = got_draws[..., 1]

    # chains: pointer doubling with carried phase sum + affine volume map.
    # Phase advances accumulate MOD 2 (rad/pi full circle): raw dphi can be
    # hundreds of cycles per frame and a raw sum would sink below float32
    # resolution (the frame loop wraps every frame for the same reason)
    dphi_m = torch.remainder(dphi_loc, 2.0)
    prev_stack = torch.stack([fin(dphi_m), fin(q_loc), fin(b_loc)], dim=-1)
    prev_stack = torch.cat([prev_stack.new_zeros((1, k, 3)), prev_stack[:-1]],
                           dim=0)
    got = lane_take(match_prev, prev_stack)
    mf = matched.to(f32)
    # state channels: 0 done, 1 lane, 2 off, 3 sumd, 4 Ac, 5 Bc,
    # 6..12 payload at birth: [ph0, vol, A, D, R, gl, gr]
    st = torch.stack([
        1.0 - mf,
        torch.where(matched, match_prev, lane_iota).to(f32),
        mf,
        mf * got[..., 0],
        torch.where(matched, got[..., 1], 1.0),
        mf * got[..., 2],
        fin(ph0_b), fin(volume), fin(A_b), fin(D_b), fin(R_b),
        fin(gl_b), fin(gr_b),
    ], dim=-1)  # (F, k, 13)
    identity = st.new_zeros((1, k, 13))
    identity[..., 0] = 1.0                                    # done
    identity[..., 1] = torch.arange(k, device=dev, dtype=f32)  # lane
    identity[..., 4] = 1.0                                    # Ac
    step_len = 1
    while step_len < F:
        n = min(step_len, F)
        rolled = torch.cat([identity.expand(n, k, 13), st[:F - n]], dim=0)
        anc = lane_take(st[..., 1].to(torch.int64), rolled)
        comp = torch.cat([
            torch.stack([anc[..., 0], anc[..., 1],
                         st[..., 2] + anc[..., 2],
                         torch.remainder(st[..., 3] + anc[..., 3], 2.0),
                         st[..., 4] * anc[..., 4],
                         st[..., 4] * anc[..., 5] + st[..., 5]], dim=-1),
            anc[..., 6:],
        ], dim=-1)
        st = torch.where(st[..., 0:1] > 0.5, st, comp)
        step_len *= 2
    off = torch.round(st[..., 2]).to(torch.int64)
    sumd = st[..., 3]
    Ac, Bc = st[..., 4], st[..., 5]
    press = (f_iota - off).to(f32) * S32  # birth frame * S
    ph0_n, vol_n = st[..., 6], st[..., 7]
    A_n, D_n, R_n = st[..., 8], st[..., 9], st[..., 10]
    gl_n, gr_n = st[..., 11], st[..., 12]
    phase_start = torch.remainder(ph0_n + sumd, 2.0)
    volb_start = Ac * vol_n + Bc

    fS = f_iota.to(f32) * S32
    # ---- alive rows ----
    alive_rows = torch.stack([
        inc_from, ratio, phase_start, c_loc, volb_start, alpha,
        fS - press,
        torch.clamp(fS - _FAR32, min=-_FAR32).expand(F, k),
        torch.full((F, k), sus, dtype=f32, device=dev),
        A_n, torch.full((F, k), hold_eff, dtype=f32, device=dev), D_n,
        torch.full((F, k), sus, dtype=f32, device=dev), R_n, gl_n, gr_n,
    ], dim=-1)  # (F, k, 16)
    n_alive = alive.sum(dim=-1)
    a_rank = torch.cumsum(alive, dim=-1) - 1
    a_tgt = torch.where(alive & (a_rank < P), a_rank, P)

    # ---- tail rows (release after the chain ends) ----
    cont_prev = torch.zeros((F, k), dtype=torch.int64, device=dev).scatter_add_(
        1, match_prev, matched.to(torch.int64)) > 0
    has_succ = torch.cat([cont_prev[1:], cont_prev.new_zeros((1, k))], dim=0)
    end = alive & ~has_succ
    nxt_data = torch.cat([is_data[1:], is_data.new_zeros((1,))])[:, None]
    has_off = end & nxt_data
    rel = torch.where(has_off, (f_iota.to(f32) + 1.0) * S32, _FAR32)
    tp_r = rel - 1.0 - press
    va = torch.clamp((tp_r + 1.0) / A_n, 0.0, 1.0)
    vd = 1.0 + (sus - 1.0) * torch.clamp((tp_r - A_n - hold_eff + 1.0)
                                         / torch.clamp(D_n, min=1.0), 0.0, 1.0)
    top_now = torch.where(tp_r < A_n, va,
                          torch.where(tp_r < A_n + hold_eff, 1.0,
                                      torch.where((D_n > 0)
                                                  & (tp_r < A_n + hold_eff + D_n),
                                                  vd, sus)))
    top_tail = torch.where(has_off, top_now, sus)
    f1 = torch.where(
        has_off,
        torch.clamp(f_iota + 1 + torch.ceil(R_n / S32).to(torch.int64) + 1,
                    max=total_frames),
        torch.where(end, total_frames, 0))
    t_need = torch.where(end, f1 - (f_iota + 1), 0)
    viol = viol | torch.any(t_need > t_max)

    # END lanes (where a tail starts) are sparse — typically a handful per
    # frame. Compact them to E lanes per frame BEFORE fanning out over t
    # offsets; more than E simultaneous note-ends in one frame trips the
    # violation predicate, like the other caps.
    E = min(k, tail_E)
    viol = viol | torch.any(end.sum(dim=-1) > E)
    e_rank = torch.cumsum(end, dim=-1) - 1
    e_tgt = torch.where(end & (e_rank < E), e_rank, E)
    end_src = torch.stack([
        inc_to, torch.remainder(phase_start + dphi_m, 2.0), q_loc, c_loc,
        volb_start, alpha, press, rel, top_tail, A_n, D_n, R_n, gl_n, gr_n,
        t_need.to(f32), torch.ones((F, k), dtype=f32, device=dev),
    ], dim=-1)  # (F, k, 16) per-end-lane tail sources + is_end marker
    end_c = torch.zeros((F, E + 1, 16), dtype=f32, device=dev).scatter_(
        1, e_tgt[..., None].expand(F, k, 16),
        torch.where(end[..., None] & torch.isfinite(end_src), end_src, 0.0)
    )[:, :E]  # (F, E, 16) compacted end lanes
    ch = lambda i: end_c[..., i]  # noqa: E731

    # Tail rows for ALL t offsets at once: result[t, g] = a[g - 1 - t]
    def shifted_stack(a, fill):
        ap = torch.cat([torch.full((t_max,) + a.shape[1:], fill, dtype=a.dtype,
                                   device=dev), a[:F - 1]], dim=0)
        return torch.stack([ap[t_max - 1 - t: t_max - 1 - t + F]
                            for t in range(t_max)], dim=0)  # (t_max, F, E)

    t_iota = torch.arange(t_max, dtype=f32, device=dev)[:, None, None]
    # mask: t < t_need of the END lane, shifted to frame f_end + 1 + t
    m_all = (shifted_stack(ch(15), 0.0) > 0.5) & (
        t_iota < shifted_stack(ch(14), 0.0))
    inc_e = shifted_stack(ch(0), 0.0)
    # t * (S*inc mod 2) mod 2 == t*S*inc mod 2 for integer t, and keeps
    # every operand small enough for float32
    step_m = torch.remainder(S32 * inc_e, 2.0)
    phase_g = torch.remainder(shifted_stack(ch(1), 0.0) + t_iota * step_m, 2.0)
    qp = torch.pow(shifted_stack(ch(2), 0.0), t_iota + 1.0)
    c_e = shifted_stack(ch(3), 0.0)
    volb_g = qp * shifted_stack(ch(4), 0.0) + (1.0 - qp) * c_e
    gS = fS[None]  # (1, F, 1) frame g sample offset
    full_tfe = lambda v: torch.full((t_max, F, E), v, dtype=f32, device=dev)  # noqa: E731
    rows_all = torch.stack([
        inc_e, full_tfe(0.0), phase_g, c_e, volb_g,
        shifted_stack(ch(5), 0.0),
        gS - shifted_stack(ch(6), 0.0),
        torch.clamp(gS - shifted_stack(ch(7), _FAR32), min=-_FAR32),
        shifted_stack(ch(8), 0.0), shifted_stack(ch(9), 0.0),
        full_tfe(hold_eff), shifted_stack(ch(10), 0.0),
        full_tfe(sus), shifted_stack(ch(11), 0.0),
        shifted_stack(ch(12), 0.0), shifted_stack(ch(13), 0.0),
    ], dim=-1)  # (t_max, F, E, 16)
    tm = m_all.transpose(0, 1).reshape(F, t_max * E)
    t_rank = torch.cumsum(tm, dim=-1) - 1 + n_alive[:, None]
    viol = viol | torch.any(n_alive + tm.sum(dim=-1) > P)
    # one scatter places the alive rows AND every tail offset: alive and
    # tail ranks are gapless and disjoint, so every live target is unique
    rows_flat = rows_all.transpose(0, 1).reshape(F, t_max * E, _NF)
    comb_tgt = torch.cat([a_tgt, torch.where(tm & (t_rank < P), t_rank, P)],
                         dim=1)
    comb_rows = torch.cat([alive_rows, rows_flat], dim=1)
    comb_mask = torch.cat([alive, tm], dim=1)
    table = defaults.expand(F, P + 1, _NF).clone()
    table.scatter_(1, comb_tgt[..., None].expand(-1, -1, _NF),
                   torch.where(comb_mask[..., None] & torch.isfinite(comb_rows),
                               comb_rows, 0.0))
    return table[:, :P], viol


def default_autotune_arrays(dtype=torch.float32, device="cuda"):
    """Dummy autotune table arrays for autotune_kind='off'."""
    dev = torch.device(device)
    return (torch.zeros((), dtype=dtype, device=dev),
            torch.zeros((8,), dtype=dtype, device=dev),
            torch.zeros((7,), dtype=dtype, device=dev),
            torch.zeros((0,), dtype=dtype, device=dev))


def _prep_lanes(freq, mag_db, loud_pitches, loud_spl, at_args, kw):
    """Lane padding + frame-local pipeline + tail-frame padding, for (F, k)
    peaks or a (B, F, k) batch of them. Returns (tpitch, volume, loud_order)
    shaped (..., total_frames, k') and k'."""
    lead = freq.shape[:-2]
    F, k = freq.shape[-2:]
    if k % 8:  # tracker lanes work in blocks of 8
        padk = 8 - k % 8
        freq = torch.nn.functional.pad(freq, (0, padk))
        mag_db = torch.nn.functional.pad(mag_db, (0, padk), value=-torch.inf)
        k += padk
    if at_args is None:
        at_args = default_autotune_arrays(freq.dtype, freq.device)
    tpitch, volume, loud_order = _frame_local(
        freq.reshape(-1, k), mag_db.reshape(-1, k), loud_pitches, loud_spl,
        *at_args,
        d=kw["nearby_distance"],
        min_volume=kw["min_volume"], pitch_method=kw["pitch_method"],
        volume_method=kw["volume_method"], shift_pre=kw["shift_pre"],
        shift_post=kw["shift_post"], analysis_volume=kw["analysis_volume"],
        harmonize_pre=kw["harmonize_pre"], harmonize_post=kw["harmonize_post"],
        autotune_kind=kw["autotune_kind"],
        autotune_max_pitch=kw["autotune_max_pitch"],
        autotune_tolerance=kw["autotune_tolerance"],
        harmonize_semantics=kw["harmonize_semantics"])
    k = tpitch.shape[-1]  # harmonize stages double the lane count
    shape = lead + (F, k)
    tpitch, volume, loud_order = (a.reshape(shape)
                                  for a in (tpitch, volume, loud_order))
    # extend through the render tail (no analysis data there: no events,
    # recurrences keep running — matches the host packer's f1 windows)
    pad = kw["total_frames"] - F
    if pad > 0:
        tpitch = torch.nn.functional.pad(tpitch, (0, 0, 0, pad), value=torch.inf)
        volume = torch.nn.functional.pad(volume, (0, 0, 0, pad))
        loud_order = torch.nn.functional.pad(loud_order, (0, 0, 0, pad))
    return tpitch, volume, loud_order, k


def _t_max(kw, n_data_frames: int) -> int:
    """Release-tail budget of the parallel tracker, in frames. The release
    length R is floored at 2.5 periods of the note; the lowest peak an STFT
    can produce is ~bin 1 (a few Hz), so tails are budgeted for a 2 Hz
    ghost note, capped at 32 frames (longer tails: the violation predicate
    sends the call to the frame loop)."""
    sr_f = float(kw["sample_rate"])
    release_eff = max(float(kw["release"]), sr_f / 1000.0, 1.0)
    min_change_floor = 2.5 * sr_f / 2.0
    total_frames = kw["total_frames"]
    t_max = int(min(total_frames, 32,
                    np.ceil(max(release_eff, min_change_floor)
                            / float(kw["stride"])) + 2))
    return max(t_max, min(total_frames - n_data_frames, 32), 1)


def _parallel_tables(tpitch, volume, loud_order, n_data_frames, pan_draws,
                     phase_draws, defaults, kw):
    """(table, violation) via the frame-parallel tracker."""
    is_data = torch.arange(kw["total_frames"], device=tpitch.device) < n_data_frames
    return _build_tables_parallel(
        tpitch, volume, loud_order, is_data, pan_draws, phase_draws, defaults,
        S=float(kw["stride"]), sr=float(kw["sample_rate"]),
        maxd=float(kw["max_track_pitches"]),
        max_voices=int(kw["max_voices"]), P=kw["n_slots"], Q=_Q,
        attack=float(kw["attack"]), hold=float(kw["hold"]),
        decay=float(kw["decay"]), sustain=float(kw["sustain"]),
        release=float(kw["release"]),
        stereo_spread=float(kw["stereo_spread"]),
        total_frames=int(kw["total_frames"]), t_max=_t_max(kw, n_data_frames),
        stable_draws=kw["draw_indexing"] == "stable")


class _ScanCarry:
    """State of the frame loop: the played set (pitch-sorted, +inf padded)
    and its slots; per-slot state with one spare row (index P) that absorbs
    the dropped writes and is never read; the draw counters and the
    dropped-NoteOn count (0-d tensors)."""

    def __init__(self, P: int, Q: int, dtype, device):
        self.pl_pitch = torch.full((Q,), torch.inf, dtype=dtype, device=device)
        self.pl_slot = torch.full((Q,), -1, dtype=torch.int64, device=device)
        self.state = torch.zeros((P + 1,), dtype=torch.int64, device=device)
        self.f1 = torch.zeros((P + 1,), dtype=torch.int64, device=device)
        sf = torch.zeros((P + 1, 14), dtype=dtype, device=device)
        for col, value in ((_S_RELEASE, FAR), (_S_TOP, 1.0), (_S_A, 1.0),
                           (_S_R, 1.0)):
            sf[:, col].fill_(value)
        self.sf = list(sf.unbind(1))
        zero = torch.zeros((), dtype=torch.int64, device=device)
        self.pan_ctr = zero
        self.phase_ctr = zero
        self.dropped = zero


def _track_step(c: _ScanCarry, tpitch, volume, loud_order, f_idx: int,
                is_data: bool, defaults, *, P: int, Q: int, statics):
    """One analysis frame: events + slot bookkeeping + table-row emission.
    Updates the carry `c`; returns the frame's (P, 16) table rows."""
    (S, sr, maxd, max_voices, attack, hold, decay, sustain, release,
     stereo_spread, total_frames, pan_draws, phase_draws,
     stable_draws) = statics
    k = tpitch.shape[0]
    dev = tpitch.device
    wdt = tpitch.dtype  # float32 serving / float64 verification
    fS = _cst(f_idx * S, wdt)
    min_dt = sr / 1000.0
    has_decay = sustain < 0.999999
    sus = min(max(sustain, 0.0), 1.0) if has_decay else 1.0
    sf = c.sf
    st_state, st_f1 = c.state, c.f1

    # (b) two-pointer tracking (rt.resynth.lib.algo.cpp:256-305) against the
    # played set's index windows [lb, ub) of each tuned pitch
    tvalid = torch.isfinite(tpitch) & is_data
    lb = torch.searchsorted(c.pl_pitch, tpitch - maxd)
    ub = torch.searchsorted(c.pl_pitch, tpitch + maxd, right=True)
    cs, matched = _two_pointer(lb[None], torch.where(tvalid, ub, -1)[None], Q)
    cs, matched = cs[0], matched[0]
    match = torch.where(matched, cs, Q)  # (k,) played index or Q
    cont = _set_drop(torch.zeros((Q,), dtype=torch.bool, device=dev), match, True)
    pl_valid = torch.isfinite(c.pl_pitch)

    # (a) free expired release tails
    st_state = torch.where((st_state == 2) & (f_idx >= st_f1), 0, st_state)

    # (c) note offs: playing, not continued (only on data frames)
    off = pl_valid & ~cont & is_data
    off_slot = torch.where(off & (c.pl_slot >= 0), c.pl_slot, P)
    press, A, H, D, R = (sf[i] for i in (_S_PRESS, _S_A, _S_H, _S_D, _S_R))
    # envelope value the release starts from (env_pressed at release-1)
    tp = (fS - 1.0) - press
    va = torch.clamp((tp + 1.0) / A, 0.0, 1.0)
    vd = 1.0 + (sus - 1.0) * torch.clamp((tp - A - H + 1.0)
                                         / torch.clamp(D, min=1.0), 0.0, 1.0)
    top_now = torch.where(tp < A, va,
                          torch.where(tp < A + H, 1.0,
                                      torch.where((D > 0) & (tp < A + H + D),
                                                  vd, sus)))
    f1_now = torch.clamp(f_idx + torch.ceil(R / S).to(torch.int64) + 1,
                         max=total_frames)
    # row P absorbs the non-offs
    off_any = torch.zeros((P + 1,), dtype=torch.bool, device=dev).index_fill_(
        0, off_slot, True)
    st_state = torch.where(off_any, 2, st_state)
    sf[_S_RELEASE] = torch.where(off_any, fS, sf[_S_RELEASE])
    sf[_S_TOP] = torch.where(off_any, top_now, sf[_S_TOP])
    st_f1 = torch.where(off_any, f1_now, st_f1)

    # (d) note changes: matched tuned retarget their slot's freq/volume and
    # update the played pitch
    ch_slot_idx = c.pl_slot[match.clamp(0, Q - 1)]  # (k,)
    ch_ok = matched & (ch_slot_idx >= 0)
    ch_slot = torch.where(ch_ok, ch_slot_idx, P)
    new_inc = 2.0 * _freq_of_pitch(tpitch) / sr
    sf[_S_CURINC] = sf[_S_CURINC].index_put((ch_slot,), new_inc)
    sf[_S_CURVOL] = sf[_S_CURVOL].index_put((ch_slot,), volume)
    pl_pitch = _set_drop(c.pl_pitch, match, tpitch)

    # (e) note ons, loudest-first among unmatched with volume > 0
    is_on = tvalid & ~matched & (volume > 0)
    on_l = is_on[loud_order]  # in loudness order
    rank_l = torch.cumsum(on_l, dim=0) - 1
    allowed_l = on_l & (cont.sum() + rank_l < max_voices)
    dropped = c.dropped + (on_l & ~allowed_l).sum()
    r_alloc_l = torch.cumsum(allowed_l, dim=0) - 1
    n_allowed = allowed_l.sum()

    free = st_state[:P] == 0
    # ascending free-slot ids by rank (host picks the first free slot)
    free_rank = torch.cumsum(free, dim=0) - 1
    free_by_rank = _set_drop(torch.zeros((P,), dtype=torch.int64, device=dev),
                             torch.where(free, free_rank, P),
                             torch.arange(P, device=dev))
    got_slot_l = allowed_l & (r_alloc_l < free.sum())
    slot_l = torch.where(got_slot_l, free_by_rank[r_alloc_l.clamp(0, P - 1)], -1)
    # phase draws go to slotted notes in pack order (= allocation order here)
    r_slot_l = torch.cumsum(got_slot_l, dim=0) - 1
    n_slotted = got_slot_l.sum()

    on_pitch_l = tpitch[loud_order]
    on_vol_l = volume[loud_order]
    on_inc_l = 2.0 * _freq_of_pitch(on_pitch_l) / sr
    if stable_draws:
        # position-keyed draws (ResynthConfig.draw_indexing="stable"):
        # index = frame * max_voices + accepted-on rank
        pan_idx = phase_idx = f_idx * max_voices + r_alloc_l
    else:
        pan_idx = c.pan_ctr + r_alloc_l
        phase_idx = c.phase_ctr + r_slot_l
    pan_l = stereo_spread * pan_draws[pan_idx.clamp(0, pan_draws.shape[0] - 1)]
    th_l = (0.25 * np.pi) * (pan_l + 1.0)
    phase0_l = phase_draws[phase_idx.clamp(0, phase_draws.shape[0] - 1)]
    min_change_l = torch.floor(0.5 + 2.5 * 2.0
                               / torch.clamp(torch.abs(on_inc_l), min=1e-9))
    A_l = torch.clamp(torch.clamp(min_change_l, min=_cst(max(attack, min_dt, 1.0), wdt)),
                      min=1.0)
    D_l = (torch.clamp(torch.clamp(min_change_l, min=_cst(max(decay, min_dt, 1.0), wdt)),
                       min=1.0)
           if has_decay else torch.zeros_like(A_l))
    R_l = torch.clamp(torch.clamp(min_change_l, min=_cst(max(release, min_dt, 1.0), wdt)),
                      min=1.0)

    tgt = torch.where(got_slot_l, slot_l, P)
    st_state = st_state.index_put((tgt,), torch.ones_like(tgt))
    st_f1 = st_f1.index_put((tgt,), torch.full_like(tgt, total_frames))
    full = lambda v: torch.full((k,), v, dtype=wdt, device=dev)  # noqa: E731
    births = torch.stack([
        full(fS), full(FAR), full(sus), A_l, full(max(hold, 0.0)), D_l, R_l,
        torch.cos(th_l), torch.sin(th_l), phase0_l, on_vol_l, on_inc_l,
        on_inc_l, on_vol_l], dim=1)  # the 14 state columns, _S_* order
    sf = list(torch.stack(sf, dim=1).index_put((tgt,), births).unbind(1))

    # (f) played-set update: keep continued, add accepted ons, stable-sorted
    # by pitch (kept-before-new on ties = std::stable_sort of the appended
    # list). Both sides are sorted, so a rank-based merge replaces the sort:
    # position(kept_i) = i' + #news strictly below; position(new_j) = j' +
    # #kept at-or-below.
    kpos = torch.where(cont, torch.cumsum(cont, dim=0) - 1, Q)
    kc_pitch = _set_drop(torch.full_like(pl_pitch, torch.inf), kpos,
                         torch.where(cont, pl_pitch, torch.inf))
    kc_slot = _set_drop(torch.full_like(c.pl_slot, -1), kpos,
                        torch.where(cont, c.pl_slot, -1))
    # news sorted by pitch WITHOUT a sort: scatter the loudness-order masks
    # back to pitch order (tpitch is already ascending), then compact
    allowed_p = torch.zeros_like(allowed_l).index_put((loud_order,), allowed_l)
    slot_p = torch.full_like(slot_l, -1).index_put((loud_order,), slot_l)
    tgtpos = torch.where(allowed_p, torch.cumsum(allowed_p, dim=0) - 1, k)
    nb_pitch = _set_drop(torch.full_like(tpitch, torch.inf), tgtpos,
                         torch.where(allowed_p, tpitch, torch.inf))
    nb_slot = _set_drop(torch.full_like(slot_p, -1), tgtpos, slot_p)
    posA = torch.arange(Q, device=dev) + torch.searchsorted(nb_pitch, kc_pitch)
    posB = torch.arange(k, device=dev) + torch.searchsorted(kc_pitch, nb_pitch,
                                                            right=True)
    pos = torch.cat([posA, posB])  # a permutation of [0, Q + k)
    c.pl_pitch = torch.full((Q + k,), torch.inf, dtype=wdt, device=dev).index_put(
        (pos,), torch.cat([kc_pitch, nb_pitch]))[:Q]
    c.pl_slot = torch.full((Q + k,), -1, dtype=torch.int64, device=dev).index_put(
        (pos,), torch.cat([kc_slot, nb_slot]))[:Q]
    c.pan_ctr = c.pan_ctr + n_allowed
    c.phase_ctr = c.phase_ctr + n_slotted
    c.dropped = dropped

    # (g) emit this frame's (P, 16) table rows, then advance recurrences
    emit = (st_state[:P] > 0) & (f_idx < st_f1[:P])
    inc_to = sf[_S_CURINC][:P]
    inc_from = sf[_S_PREVINC][:P]
    ratio = torch.where(inc_to == inc_from, 0.0,
                        torch.log(torch.clamp(inc_to, min=1e-30)
                                  / torch.clamp(inc_from, min=1e-30)))
    alpha = 1.0 - torch.exp(-np.pi * torch.clamp(torch.abs(inc_to),
                                                 max=_cst(2.0 / S, wdt)))
    col = lambda i: sf[i][:P]  # noqa: E731
    rows = torch.stack([
        inc_from, ratio, col(_S_PHASE), col(_S_CURVOL), col(_S_VOLB), alpha,
        fS - col(_S_PRESS), torch.clamp(fS - col(_S_RELEASE), min=-FAR),
        col(_S_TOP), col(_S_A), col(_S_H), col(_S_D),
        torch.full((P,), sus, dtype=wdt, device=dev), col(_S_R),
        col(_S_GL), col(_S_GR)], dim=-1)
    row_block = torch.where(emit[:, None], rows, defaults)

    lam = ratio / S
    dphi = torch.where(ratio == 0.0, S * inc_from,
                       inc_from / torch.where(lam == 0, 1.0, lam)
                       * torch.expm1(ratio))
    spare = lambda a, full_col: torch.cat([a, full_col[P:]])  # noqa: E731
    sf[_S_PHASE] = spare(torch.where(emit, torch.remainder(col(_S_PHASE) + dphi, 2.0),
                                     col(_S_PHASE)), sf[_S_PHASE])
    sf[_S_VOLB] = spare(torch.where(
        emit, col(_S_CURVOL) + (col(_S_VOLB) - col(_S_CURVOL))
        * torch.pow(1.0 - alpha, _cst(S, wdt)), col(_S_VOLB)), sf[_S_VOLB])
    sf[_S_PREVINC] = spare(torch.where(emit, inc_to, inc_from), sf[_S_PREVINC])
    c.sf = sf
    c.state, c.f1 = st_state, st_f1
    return row_block


def _scan_tables_plain(tpitch, volume, loud_order, n_data_frames, pan_draws,
                       phase_draws, defaults, kw):
    """One job's (T, k) lanes -> ((T, P, 16) table, dropped) via the frame
    loop in plain PyTorch, one `_track_step` a frame (the exact path:
    voice-cap drops, slot overflow, long tails, min_volume <= 0)."""
    P = kw["n_slots"]
    total_frames = kw["total_frames"]
    statics = (float(kw["stride"]), float(kw["sample_rate"]),
               float(kw["max_track_pitches"]), int(kw["max_voices"]),
               float(kw["attack"]), float(kw["hold"]), float(kw["decay"]),
               float(kw["sustain"]), float(kw["release"]),
               float(kw["stereo_spread"]), int(total_frames),
               pan_draws, phase_draws,
               kw["draw_indexing"] == "stable")
    carry = _ScanCarry(P, _Q, tpitch.dtype, tpitch.device)
    rows = [_track_step(carry, tpitch[f], volume[f], loud_order[f], f,
                        f < n_data_frames, defaults, P=P, Q=_Q, statics=statics)
            for f in range(total_frames)]
    return torch.stack(rows), carry.dropped


def ready(device) -> None:
    """Loads the exact frame loop's kernel library (built once) when
    `device` is a CUDA device, so that no build or load lands inside a job
    whose tables take the loop; nothing on other devices."""
    if torch.device(device).type == "cuda":
        cuda_scan.load_library()


def _scan_tables(tpitch, volume, loud_order, n_data_frames, pan_draws,
                 phase_draws, defaults, kw):
    """(B, T, k) lanes of B jobs -> ((B, T, P, 16) tables, (B,) dropped) via
    the exact frame loop. CPU tensors take _scan_tables_plain job by job;
    CUDA tensors one launch of the frame-loop kernel for every job
    (ops/cuda_scan, csrc/tracker_scan.cu), or an exception."""
    global FRAME_LOOPS
    FRAME_LOOPS += tpitch.shape[0]
    if tpitch.device.type == "cuda":
        return cuda_scan.scan_tables_cuda(tpitch, volume, loud_order,
                                          n_data_frames, pan_draws, phase_draws,
                                          defaults, kw)
    if tpitch.device.type != "cpu":
        raise ValueError(f"no exact frame loop for tensors on {tpitch.device}")
    scans = [_scan_tables_plain(tpitch[b], volume[b], loud_order[b],
                                n_data_frames, pan_draws, phase_draws, defaults, kw)
             for b in range(tpitch.shape[0])]
    return (torch.stack([t for t, _ in scans]),
            torch.stack([d for _, d in scans]))


def _inputs(freq, mag_db, loud_pitches, loud_spl, pan_draws, phase_draws,
            autotune_arrays, device):
    """Every input as a tensor on `device` in the peaks' working dtype."""
    dev = torch.device(device)
    freq = torch.as_tensor(freq, device=dev)
    wdt = freq.dtype
    cast = lambda a: torch.as_tensor(a, dtype=wdt, device=dev)  # noqa: E731
    at = None if autotune_arrays is None else tuple(cast(a) for a in autotune_arrays)
    return (freq, cast(mag_db), cast(loud_pitches), cast(loud_spl),
            cast(pan_draws), cast(phase_draws), at)


def _keywords(*, total_frames: int, stride: int, sample_rate: float,
              max_voices: int, n_slots: int, nearby_distance: float,
              min_volume: float, max_track_pitches: float, pitch_method: int,
              volume_method: int, analysis_volume: float, shift_pre: float,
              shift_post: float, stereo_spread: float, attack: float,
              hold: float, decay: float, sustain: float, release: float,
              harmonize_pre: float = 0.0, harmonize_post: float = 0.0,
              autotune_kind: str = "off", autotune_max_pitch: float = 150.0,
              autotune_tolerance: float = 100.0,
              harmonize_semantics: str = "merged",
              draw_indexing: str = "sequential") -> dict:
    """The tracker's keywords, with their defaults, as the dict that every
    stage below the entries reads by key. autotune_kind: 'off' | 'scale' |
    'allowed' (chain.autotune_device_arrays gives the arrays). The played
    set holds _Q pitches (and the frame-loop kernel's, ops/cuda_scan.Q), so
    max_voices is at most _Q - 1: with more, note-ons would be lost without
    a count."""
    if max_voices > _Q - 1:
        raise ValueError(f"device tracker supports max_voices <= {_Q - 1}")
    return dict(locals())


def _stack(tensors):
    """torch.stack of a job axis; one job's tensor as a view, not a copy."""
    return tensors[0][None] if len(tensors) == 1 else torch.stack(tensors)


def _tries_frame_parallel(device_type: str, min_volume: float,
                          force_scan: bool) -> bool:
    """Whether a call tries the frame-parallel tracker before the exact
    frame loop. The try needs min_volume > 0 (its played-set identity rests
    on it) and force_scan false. On a CUDA device the loop is one launch of
    the frame-loop kernel for every job, with no host read, where the
    frame-parallel pass is ~1,200 ATen ops a job and a flag read: so the
    card never tries it."""
    return device_type != "cuda" and min_volume > 0 and not force_scan


def _tables(freq, mag_db, loud_pitches, loud_spl, pan_draws, phase_draws, *,
            device, autotune_arrays=None, force_scan: bool = False, **kw):
    """(B, F, k) peaks of B jobs -> ((B, total_frames, n_slots, 16) tables,
    (B,) dropped), on `device`: the routing behind every entry. Arrays that
    are not tensors on `device` are moved there; the working dtype is
    freq's; kw: _keywords'.

    The frame-local stage runs once over every job's frames. Where
    _tries_frame_parallel (off the card), the frame-parallel tracker runs per job and the jobs' violation flags
    are read on the host as one (one synchronisation, counted in
    HOST_SYNCS); with none set its tables are the result. Otherwise every
    job takes the exact frame loop, in one call of _scan_tables (on the
    card one launch)."""
    global HOST_SYNCS
    kw = _keywords(**kw)
    freq, mag_db, loud_pitches, loud_spl, pan_draws, phase_draws, at = _inputs(
        freq, mag_db, loud_pitches, loud_spl, pan_draws, phase_draws,
        autotune_arrays, device)
    B, F, _ = freq.shape
    tpitch, volume, loud_order, _k = _prep_lanes(freq, mag_db, loud_pitches,
                                                 loud_spl, at, kw)
    defaults = _default_row(freq.dtype, freq.device)
    if _tries_frame_parallel(freq.device.type, kw["min_volume"], force_scan):
        par = [_parallel_tables(tpitch[b], volume[b], loud_order[b], F,
                                pan_draws, phase_draws, defaults, kw)
               for b in range(B)]
        HOST_SYNCS += 1
        if not bool(_stack([v for _, v in par]).any()):
            return (_stack([t for t, _ in par]),
                    torch.zeros((B,), dtype=torch.int64, device=freq.device))
    return _scan_tables(tpitch, volume, loud_order, F, pan_draws, phase_draws,
                        defaults, kw)


def build_tables_device_batch(freq, mag_db, loud_pitches, loud_spl,
                              pan_draws, phase_draws, *, device="cuda", **kw):
    """Batched-serving variant: freq/mag are (B, F, k); returns
    ((B, total_frames, n_slots, 16), (B,) dropped). Keywords as
    build_tables_device's, but for _force_scan.

    On the card every job's table is the frame loop's, from one kernel
    launch for the batch (one CTA a job, so each job's table equals its
    build_tables_device call's to the bit). Where the frame-parallel
    tracker is tried, the violation is hoisted over the batch: any job
    violating sends every job down the frame loop (one flag read per
    batch; _tables)."""
    return _tables(freq, mag_db, loud_pitches, loud_spl, pan_draws, phase_draws,
                   device=device, **kw)


def build_tables_device(freq, mag_db, loud_pitches, loud_spl, pan_draws,
                        phase_draws, *, device="cuda", _force_scan: bool = False,
                        **kw):
    """(F, k) peak arrays -> ((total_frames, n_slots, 16) table,
    dropped-NoteOn count), on `device`. Arrays that are not tensors on
    `device` are moved there; the working dtype is freq's.

    Keywords: those of _keywords (the render's total_frames, stride and
    sample_rate, the ResynthConfig's tracker settings, the envelope; the
    harmonize, autotune and draw-indexing ones have defaults), and
    autotune_arrays = (root_pitch (), scale (8,), equidistant (7,),
    allowed (A,)) for autotune_kind 'scale' or 'allowed' (see
    chain.autotune_device_arrays / analysis.autotune.autotune_tables).

    On the card the exact frame loop builds the table in one kernel
    launch, with no host read (_tables, with this job as a batch of one).
    On the CPU the frame-parallel tracker runs first (min_volume > 0); its violation flag is read on the
    host (one synchronisation, counted in HOST_SYNCS) and, when set, the
    exact frame loop runs instead, on the same device. _force_scan: the
    frame loop without the frame-parallel try, on any device.
    """
    tables, dropped = _tables(freq[None], mag_db[None], loud_pitches, loud_spl,
                              pan_draws, phase_draws, device=device,
                              force_scan=_force_scan, **kw)
    return tables[0], dropped[0]


def split_increment(table: torch.Tensor) -> torch.Tensor:
    """(..., 16) float64 table -> (..., 17) with the JAX df table's
    increment contract (JAX device_tracker.py:1228): field 0 holds the
    increment rounded to float32, field 16 the rest, inc - float32(inc), so
    field 0 + field 16 is the increment exactly."""
    inc = table[..., _F_INC]
    hi = inc.to(torch.float32).to(table.dtype)
    return torch.cat([table[..., :_F_INC], hi[..., None],
                      table[..., _F_INC + 1:], (inc - hi)[..., None]], dim=-1)


def build_tables_device_df(freq, mag_db, loud_pitches, loud_spl, pan_draws,
                           phase_draws, *, device="cuda", _force_scan: bool = False,
                           **kw):
    """The fidelity chain's tracker: (F, k) float64 peaks -> ((total_frames,
    n_slots, 17) float64 table, dropped), on `device`.

    Port of JAX device_tracker.py:2070, which re-runs the float32 tracker's
    semantics with every decision quantity and recurrence carried as df32
    (hi, lo) pairs because the TPU has no float64. Here the values are
    float64 inside: the same routing as build_tables_device (frame-local
    stage, then on the card the exact frame loop's float64 kernel; on the
    CPU the frame-parallel tracker, or the exact frame loop when its
    violation flag is set), at float64, with its keywords (autotune_arrays
    float64, _force_scan). The 17th field follows JAX's contract
    (split_increment), so the render takes the df-phase path and JAX's df
    tables and these compare field by field.

    One deliberate difference: on a violation JAX falls back to its float32
    frame loop with a zero field 16 (:2092-2098); here the frame loop runs
    at float64 and field 0 is split as everywhere else.

    The table is build_tables_device's, looked up on this module at each
    call, so that a wrapper set there (the benchmark's harness keeps the
    peaks through one) sees the fidelity chain's peaks too.
    """
    freq = torch.as_tensor(freq, device=torch.device(device))
    if freq.dtype != torch.float64:
        raise ValueError(f"the fidelity tracker takes float64 peaks, got {freq.dtype}")
    table, dropped = build_tables_device(freq, mag_db, loud_pitches, loud_spl,
                                         pan_draws, phase_draws, device=device,
                                         _force_scan=_force_scan, **kw)
    return split_increment(table), dropped
