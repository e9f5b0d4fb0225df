"""Native CLEAR + Identity + HOTA tracking metrics (MOTA/MOTP/IDSW/Frag,
IDF1, HOTA/DetA/AssA).

A copy of `reid_tpu/tracking/metrics.py` (NumPy and SciPy only; importing
it would pull in JAX through `reid_tpu.tracking`), unchanged below this
paragraph. tests/test_torch_metrics.py holds the two equal.

The reference scores tracking through the external TrackEval repo
(ref `MOT16_eval/eval.sh:107-109` --METRICS CLEAR Identity); this module
provides the same headline metrics natively so sequences can be scored
in-framework (and in tests) without TrackEval.

Semantics follow TrackEval's algorithms exactly (property-tested against an
independent oracle in tests/test_metrics.py):

CLEAR (Bernardin & Stiefelhagen, TrackEval clear.py):
  * per frame, score = 1000 * [hyp id == gt's previous-TIMESTEP match]
    + IoU, with entries below the 0.5 IoU threshold zeroed (the continuity
    bonus cannot rescue a sub-threshold overlap); one Hungarian assignment
    maximizes the score, and pairs with positive score are the TPs,
  * MOTA = 1 - (FN + FP + IDSW) / num_gt;  MOTP = mean IoU of TPs (x100),
  * IDSW counts a TP whose gt's last-ever matched hyp id differs,
  * Frag = (number of contiguous matched runs - 1) summed over gt tracks.

Identity (Ristani et al., TrackEval identity.py):
  * co-occurrence counts over ALL IoU-feasible (gt id, hyp id) pairs per
    frame — independent of the CLEAR per-frame matching,
  * one global max-weight bipartite matching over id pairs gives IDTP;
    IDF1 = 2*IDTP / (total gt boxes + total hyp boxes), IDP = IDTP/num_hyp,
    IDR = IDTP/num_gt.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Tuple

import numpy as np

_EPS = np.finfo(np.float64).eps


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, :2] + a[:, None, 2:4],
                    b[None, :, :2] + b[None, :, 2:4])
    wh = np.maximum(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] * a[:, 3])[:, None]
    area_b = (b[:, 2] * b[:, 3])[None, :]
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def evaluate_clear_identity(
    gt_frames: Dict[int, Tuple[np.ndarray, np.ndarray]],
    hyp_frames: Dict[int, Tuple[np.ndarray, np.ndarray]],
    iou_thr: float = 0.5,
) -> Dict[str, float]:
    """gt_frames / hyp_frames: {frame: (tlwh (N,4), ids (N,))}.

    Returns dict with MOTA, MOTP, IDSW, Frag, FP, FN, TP, IDF1, IDP, IDR,
    num_gt.
    """
    from scipy.optimize import linear_sum_assignment

    frames = sorted(set(gt_frames) | set(hyp_frames))
    prev_timestep: Dict[int, int] = {}   # gt id -> hyp matched LAST timestep
    prev_ever: Dict[int, int] = {}       # gt id -> last hyp ever matched
    match_runs: Dict[int, int] = defaultdict(int)   # gt id -> matched runs
    in_run: Dict[int, bool] = defaultdict(bool)
    fp = fn = tp = idsw = 0
    num_gt = num_hyp = 0
    motp_sum = 0.0
    # Identity: ALL IoU-feasible co-occurrences (not CLEAR matches)
    co = defaultdict(int)                # (gt id, hyp id) -> co-occurrences

    for f in frames:
        g_boxes, g_ids = gt_frames.get(f, (np.zeros((0, 4)), np.zeros(0, int)))
        h_boxes, h_ids = hyp_frames.get(f, (np.zeros((0, 4)), np.zeros(0, int)))
        g_boxes = np.asarray(g_boxes, float)
        h_boxes = np.asarray(h_boxes, float)
        g_ids = np.asarray(g_ids, int)
        h_ids = np.asarray(h_ids, int)
        num_gt += len(g_ids)
        num_hyp += len(h_ids)

        iou = _iou_matrix(g_boxes, h_boxes)
        # TrackEval's thresholds: identity.py uses `>= thr`, clear.py zeroes
        # `< thr - eps`; mirror both exactly
        for gi, hj in zip(*np.nonzero(iou >= iou_thr)):
            co[(int(g_ids[gi]), int(h_ids[hj]))] += 1
        feasible = iou >= iou_thr - _EPS

        matched_this = {}
        if len(g_ids) and len(h_ids):
            prev = np.asarray([prev_timestep.get(int(g), -1) for g in g_ids])
            bonus = 1000.0 * (h_ids[None, :] == prev[:, None])
            score = bonus + iou
            score[~feasible] = 0.0
            rows, cols = linear_sum_assignment(-score)
            ok = score[rows, cols] > _EPS
            for r, c in zip(rows[ok], cols[ok]):
                gid, hid = int(g_ids[r]), int(h_ids[c])
                if gid in prev_ever and prev_ever[gid] != hid:
                    idsw += 1
                prev_ever[gid] = hid
                matched_this[gid] = hid
                motp_sum += iou[r, c]
                tp += 1

        fn += len(g_ids) - len(matched_this)
        fp += len(h_ids) - len(matched_this)
        # continuity bonus applies only to the immediately previous timestep
        prev_timestep = matched_this
        # Frag: count contiguous matched runs per gt over its PRESENCE frames
        for gid in g_ids:
            gid = int(gid)
            if gid in matched_this:
                if not in_run[gid]:
                    match_runs[gid] += 1
                in_run[gid] = True
            else:
                in_run[gid] = False

    frag = sum(max(0, runs - 1) for runs in match_runs.values())

    # Identity: global max-weight bipartite over id pairs (weights >= 0, so
    # the rectangular assignment attains the max-weight matching)
    gids = sorted({g for g, _ in co})
    hids = sorted({h for _, h in co})
    if gids and hids:
        mat = np.zeros((len(gids), len(hids)))
        gpos = {g: i for i, g in enumerate(gids)}
        hpos = {h: j for j, h in enumerate(hids)}
        for (g, h), c in co.items():
            mat[gpos[g], hpos[h]] = c
        from scipy.optimize import linear_sum_assignment
        rows, cols = linear_sum_assignment(-mat)
        idtp = mat[rows, cols].sum()
    else:
        idtp = 0.0
    idf1 = 2.0 * idtp / max(num_gt + num_hyp, 1)

    return {
        "MOTA": 100.0 * (1.0 - (fn + fp + idsw) / max(num_gt, 1)),
        "MOTP": 100.0 * (motp_sum / max(tp, 1)),
        "IDSW": float(idsw),
        "Frag": float(frag),
        "FP": float(fp),
        "FN": float(fn),
        "TP": float(tp),
        "IDF1": 100.0 * idf1,
        "IDP": 100.0 * idtp / max(num_hyp, 1),
        "IDR": 100.0 * idtp / max(num_gt, 1),
        "IDTP": float(idtp),
        "num_gt": float(num_gt),
        "num_hyp": float(num_hyp),
    }


def combine_sequences(per_seq: Dict[str, Dict[str, float]]
                      ) -> Dict[str, float]:
    """TrackEval-style COMBINED row: sum the integer counters over
    sequences and recompute the ratios (clear.py/identity.py
    combine_sequences), rather than averaging per-sequence percentages."""
    tot = {k: sum(m[k] for m in per_seq.values())
           for k in ("FP", "FN", "TP", "IDSW", "Frag", "IDTP", "num_gt",
                     "num_hyp")}
    motp_sum = sum(m["MOTP"] * m["TP"] for m in per_seq.values()) / 100.0
    return {
        "MOTA": 100.0 * (1.0 - (tot["FN"] + tot["FP"] + tot["IDSW"])
                         / max(tot["num_gt"], 1)),
        "MOTP": 100.0 * motp_sum / max(tot["TP"], 1),
        "IDSW": tot["IDSW"], "Frag": tot["Frag"], "FP": tot["FP"],
        "FN": tot["FN"], "TP": tot["TP"],
        "IDF1": 200.0 * tot["IDTP"] / max(tot["num_gt"] + tot["num_hyp"], 1),
        "IDP": 100.0 * tot["IDTP"] / max(tot["num_hyp"], 1),
        "IDR": 100.0 * tot["IDTP"] / max(tot["num_gt"], 1),
        "IDTP": tot["IDTP"], "num_gt": tot["num_gt"],
        "num_hyp": tot["num_hyp"],
    }


def load_mot_frames(path: str) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    """Parse a MOT RESULT txt (frame,id,l,t,w,h[,conf,-1,-1,-1]) into
    {frame: (tlwh, ids)}.

    For 9-column MOT16 gt files prefer `load_mot_gt` + `preprocess_mot`
    (TrackEval's MotChallenge2DBox semantics: distractor-match removal,
    zero-mark + pedestrian-class gt filter); this simple parser keeps only
    class ∈ {1, -1} rows and applies NO preprocessing."""
    per: Dict[int, list] = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            vals = [float(v) for v in parts]
            if len(vals) >= 8 and vals[7] not in (1.0, -1.0):
                continue  # non-pedestrian gt class
            per[int(vals[0])].append((vals[2:6], int(vals[1])))
    out = {}
    for fidx, rows in per.items():
        out[fidx] = (np.asarray([r[0] for r in rows], float),
                     np.asarray([r[1] for r in rows], int))
    return out


# ---------------------------------------------------------------------------
# TrackEval MotChallenge2DBox preprocessing (the semantics behind the
# reference's MOT16_eval/eval.sh:107-109 run_mot_challenge.py scoring).
# MOT class ids (MOTChallenge devkit): 1 pedestrian, 2 person_on_vehicle,
# 3 car, 4 bicycle, 5 motorbike, 6 non_mot_vehicle, 7 static_person,
# 8 distractor, 9-11 occluders, 12 reflection, 13 crowd.
# ---------------------------------------------------------------------------

MOT_PEDESTRIAN = 1
MOT_DISTRACTOR_CLASSES = (2, 7, 8, 12)  # person_on_vehicle, static_person,
                                        # distractor, reflection
# TrackEval adds non_mot_vehicle (6) to the distractor set for MOT20 only
# (MotChallenge2DBox: `if benchmark == 'MOT20': distractor_class_names
# .append('non_mot_vehicle')`).
MOT20_DISTRACTOR_CLASSES = MOT_DISTRACTOR_CLASSES + (6,)
MOT_CROWD_CLASS = 13


def load_mot_gt(path: str) -> Dict[int, Dict[str, np.ndarray]]:
    """Parse a FULL 9-column MOT16/17/20 gt.txt:
    frame,id,left,top,w,h,conf(zero-mark),class,visibility.

    Returns {frame: {"tlwh" (N,4), "ids" (N,), "classes" (N,),
    "zero_marked" (N,), "visibility" (N,)}}. Crowd rows (class 13) are
    routed out at load time — TrackEval's crowd_ignore_filter {7: ['13']}
    excludes them from gt_dets entirely, so they never participate in the
    distractor matching either. Missing columns default to conf=1
    (considered), class=pedestrian, visibility=1, matching TrackEval's
    handling of short gt rows. Visibility is parsed and returned for
    callers but — like TrackEval's MOT16 pipeline — not used as a filter.
    """
    per: Dict[int, list] = defaultdict(list)
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 6:
                continue
            vals = [float(v) for v in parts]
            conf = vals[6] if len(vals) > 6 else 1.0
            cls = int(vals[7]) if len(vals) > 7 else MOT_PEDESTRIAN
            vis = vals[8] if len(vals) > 8 else 1.0
            if cls == MOT_CROWD_CLASS:
                continue  # crowd ignore region, excluded from gt dets
            per[int(vals[0])].append((vals[2:6], int(vals[1]), cls, conf,
                                      vis))
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for fidx, rows in per.items():
        out[fidx] = {
            "tlwh": np.asarray([r[0] for r in rows], float).reshape(-1, 4),
            "ids": np.asarray([r[1] for r in rows], int),
            "classes": np.asarray([r[2] for r in rows], int),
            "zero_marked": np.asarray([r[3] for r in rows], float),
            "visibility": np.asarray([r[4] for r in rows], float),
        }
    return out


def preprocess_mot(
    gt_raw: Dict[int, Dict[str, np.ndarray]],
    hyp_frames: Dict[int, Tuple[np.ndarray, np.ndarray]],
    distractor_removal: bool = True,
    benchmark: str = "MOT16",
) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]],
           Dict[int, Tuple[np.ndarray, np.ndarray]]]:
    """TrackEval MotChallenge2DBox.get_preprocessed_seq_data (pedestrian
    class, DO_PREPROC, MOT16/17/20 benchmarks), per frame:

      1. Hungarian-match tracker dets against ALL loaded gt rows (any class;
         crowd already excluded at load) on IoU, with scores below
         0.5 - eps zeroed and a match requiring score > eps; tracker dets
         whose matched gt row is a DISTRACTOR class are removed.
      2. gt kept for scoring = zero_marked != 0 AND class == pedestrian.

    The 0.5 matching threshold is TrackEval's hard-coded preproc constant,
    independent of the scoring threshold. Set `distractor_removal=False`
    for MOT15-style gt (no class column ⇒ step 1 skipped, step 2 keeps
    every non-zero-marked row — TrackEval's `benchmark == 'MOT15'` branch).
    `benchmark="MOT20"` widens the distractor set with non_mot_vehicle
    (class 6), matching TrackEval's MOT20 branch.

    Returns (gt_frames, hyp_frames) in `evaluate_clear_identity` format.
    """
    from scipy.optimize import linear_sum_assignment

    gt_out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    hyp_out: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    frames = sorted(set(gt_raw) | set(hyp_frames))
    empty = (np.zeros((0, 4), float), np.zeros(0, int))
    for f in frames:
        g = gt_raw.get(f)
        h_boxes, h_ids = hyp_frames.get(f, empty)
        h_boxes = np.asarray(h_boxes, float).reshape(-1, 4)
        h_ids = np.asarray(h_ids, int)

        if g is None:
            gt_out[f] = empty
            hyp_out[f] = (h_boxes, h_ids)
            continue

        to_remove = np.zeros(len(h_ids), bool)
        if distractor_removal and len(g["ids"]) and len(h_ids):
            iou = _iou_matrix(np.asarray(g["tlwh"], float), h_boxes)
            matching = iou.copy()
            matching[matching < 0.5 - _EPS] = 0.0
            rows, cols = linear_sum_assignment(-matching)
            ok = matching[rows, cols] > _EPS
            rows, cols = rows[ok], cols[ok]
            distractors = (MOT20_DISTRACTOR_CLASSES if benchmark == "MOT20"
                           else MOT_DISTRACTOR_CLASSES)
            is_distractor = np.isin(g["classes"][rows], distractors)
            to_remove[cols[is_distractor]] = True

        hyp_out[f] = (h_boxes[~to_remove], h_ids[~to_remove])

        keep = np.not_equal(g["zero_marked"], 0)
        if distractor_removal:  # class column present (MOT16/17/20)
            keep &= np.equal(g["classes"], MOT_PEDESTRIAN)
        gt_out[f] = (np.asarray(g["tlwh"], float)[keep],
                     np.asarray(g["ids"], int)[keep])
    return gt_out, hyp_out


# ---------------------------------------------------------------------------
# HOTA (Luiten et al., IJCV 2021) — TrackEval-exact semantics.
#
# BEYOND the reference: its eval.sh runs TrackEval with `--METRICS CLEAR
# Identity` only, and TRACKING_EVAL.md:3 promises "HOTA will be applied
# soon"; this delivers that natively.  Algorithm (TrackEval hota.py):
#
#   alphas = 0.05, 0.10, ..., 0.95 (19 IoU thresholds)
#   pass 1: accumulate per-(gt id, hyp id) "potential match" mass
#           sum_t iou / (row-sum + col-sum - iou)   (a per-det Jaccard
#           share), and per-id detection counts; the global alignment
#           score is potential / (count_g + count_h - potential).
#   pass 2: per frame, ONE Hungarian assignment maximizing
#           global_alignment[idg, idh] * iou (alpha-independent — the
#           global score breaks ties toward consistent id pairings);
#           per alpha, pairs with iou >= alpha are the TPs.
#   AssA(alpha) = TP-weighted mean over matches of
#           A(c) = TPA / (TPA + FNA + FPA)  where for a matched id pair c,
#           TPA = times the pair was matched, and the denominator is
#           count_g + count_h - TPA.
#   DetA(alpha) = TP / (TP + FN + FP);  HOTA(alpha) = sqrt(DetA * AssA);
#   headline HOTA = mean over the 19 alphas.
# ---------------------------------------------------------------------------

HOTA_ALPHAS = np.arange(0.05, 0.99, 0.05)


def evaluate_hota(
    gt_frames: Dict[int, Tuple[np.ndarray, np.ndarray]],
    hyp_frames: Dict[int, Tuple[np.ndarray, np.ndarray]],
    alphas: np.ndarray | None = None,
) -> Dict[str, float]:
    """gt_frames / hyp_frames: {frame: (tlwh (N,4), ids (N,))} — the same
    (already preprocessed) format `evaluate_clear_identity` takes.

    Returns headline scalars (HOTA/DetA/AssA/DetRe/DetPr/AssRe/AssPr/LocA/
    OWTA = alpha-means x100, plus HOTA(0)/LocA(0)/HOTALocA(0) at the lowest
    alpha) and the per-alpha counter arrays under "_hota" for TrackEval-style
    cross-sequence pooling (`combine_sequences_hota`)."""
    from scipy.optimize import linear_sum_assignment

    alphas = HOTA_ALPHAS if alphas is None else np.asarray(alphas, float)
    n_a = len(alphas)
    frames = sorted(set(gt_frames) | set(hyp_frames))
    empty = (np.zeros((0, 4), float), np.zeros(0, int))

    # contiguous id relabel over the whole sequence
    gids = sorted({int(i) for f in frames
                   for i in np.asarray(gt_frames.get(f, empty)[1]).ravel()})
    hids = sorted({int(i) for f in frames
                   for i in np.asarray(hyp_frames.get(f, empty)[1]).ravel()})
    gpos = {g: i for i, g in enumerate(gids)}
    hpos = {h: j for j, h in enumerate(hids)}
    n_g, n_h = len(gids), len(hids)

    # pass 1: potential-match mass + per-id det counts
    per_frame = []
    potential = np.zeros((n_g, n_h))
    gt_count = np.zeros((n_g, 1))
    hyp_count = np.zeros((1, n_h))
    for f in frames:
        g_boxes, g_ids = gt_frames.get(f, empty)
        h_boxes, h_ids = hyp_frames.get(f, empty)
        gi = np.asarray([gpos[int(i)] for i in np.asarray(g_ids).ravel()], int)
        hj = np.asarray([hpos[int(i)] for i in np.asarray(h_ids).ravel()], int)
        iou = _iou_matrix(np.asarray(g_boxes, float).reshape(-1, 4),
                          np.asarray(h_boxes, float).reshape(-1, 4))
        per_frame.append((gi, hj, iou))
        if len(gi) and len(hj):
            denom = iou.sum(0)[None, :] + iou.sum(1)[:, None] - iou
            share = np.zeros_like(iou)
            mask = denom > _EPS
            share[mask] = iou[mask] / denom[mask]
            potential[gi[:, None], hj[None, :]] += share
        gt_count[gi, 0] += 1
        hyp_count[0, hj] += 1

    if n_g and n_h:
        global_align = potential / np.maximum(
            gt_count + hyp_count - potential, _EPS)
    else:
        global_align = np.zeros((n_g, n_h))

    # pass 2: one Hungarian per frame, then per-alpha thresholding
    tp = np.zeros(n_a)
    fn = np.zeros(n_a)
    fp = np.zeros(n_a)
    loca_sum = np.zeros(n_a)
    match_counts = np.zeros((n_a, n_g, n_h))
    for gi, hj, iou in per_frame:
        if len(gi) == 0:
            fp += len(hj)
            continue
        if len(hj) == 0:
            fn += len(gi)
            continue
        score = global_align[gi[:, None], hj[None, :]] * iou
        rows, cols = linear_sum_assignment(-score)
        sim = iou[rows, cols]
        for a in range(n_a):
            ok = sim + _EPS >= alphas[a]
            n_match = int(ok.sum())
            tp[a] += n_match
            fn[a] += len(gi) - n_match
            fp[a] += len(hj) - n_match
            if n_match:
                loca_sum[a] += float(sim[ok].sum())
                match_counts[a][gi[rows[ok]], hj[cols[ok]]] += 1

    ass_a = np.zeros(n_a)
    ass_re = np.zeros(n_a)
    ass_pr = np.zeros(n_a)
    for a in range(n_a):
        mc = match_counts[a]
        union = np.maximum(1.0, gt_count + hyp_count - mc)
        ass_a[a] = float((mc * (mc / union)).sum()) / max(1.0, tp[a])
        ass_re[a] = float((mc * (mc / np.maximum(1.0, gt_count))).sum()) \
            / max(1.0, tp[a])
        ass_pr[a] = float((mc * (mc / np.maximum(1.0, hyp_count))).sum()) \
            / max(1.0, tp[a])

    return _hota_final_fields({
        "alphas": alphas, "HOTA_TP": tp, "HOTA_FN": fn, "HOTA_FP": fp,
        "LocA_sum": loca_sum, "AssA_alpha": ass_a, "AssRe_alpha": ass_re,
        "AssPr_alpha": ass_pr,
    })


def _hota_final_fields(arrays: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Counters + per-alpha association arrays -> headline scalars (x100,
    alpha-means), keeping the raw arrays under "_hota" for pooling."""
    tp, fn, fp = (arrays[k] for k in ("HOTA_TP", "HOTA_FN", "HOTA_FP"))
    loca = np.maximum(1e-10, arrays["LocA_sum"]) / np.maximum(1e-10, tp)
    det_re = tp / np.maximum(1.0, tp + fn)
    det_pr = tp / np.maximum(1.0, tp + fp)
    det_a = tp / np.maximum(1.0, tp + fn + fp)
    hota = np.sqrt(det_a * arrays["AssA_alpha"])
    owta = np.sqrt(det_re * arrays["AssA_alpha"])
    return {
        "HOTA": 100.0 * float(hota.mean()),
        "DetA": 100.0 * float(det_a.mean()),
        "AssA": 100.0 * float(arrays["AssA_alpha"].mean()),
        "DetRe": 100.0 * float(det_re.mean()),
        "DetPr": 100.0 * float(det_pr.mean()),
        "AssRe": 100.0 * float(arrays["AssRe_alpha"].mean()),
        "AssPr": 100.0 * float(arrays["AssPr_alpha"].mean()),
        "LocA": 100.0 * float(loca.mean()),
        "OWTA": 100.0 * float(owta.mean()),
        "HOTA(0)": 100.0 * float(hota[0]),
        "LocA(0)": 100.0 * float(loca[0]),
        "HOTALocA(0)": 100.0 * float(hota[0] * loca[0]),
        "_hota": arrays,
    }


def combine_sequences_hota(per_seq: Dict[str, Dict[str, float]]
                           ) -> Dict[str, float]:
    """TrackEval hota.py combine_sequences: sum the per-alpha TP/FN/FP
    counters, pool AssA/AssRe/AssPr and LocA as TP-weighted means, then
    recompute the final fields — NOT an average of per-sequence HOTAs."""
    missing = [k for k, m in per_seq.items() if "_hota" not in m]
    if missing:
        raise ValueError(
            "combine_sequences_hota needs the per-alpha counter arrays "
            f"('_hota' key) but sequences {missing} lack them — score them "
            "with evaluate_hota, or evaluate_mot16(keep_hota_arrays=True).")
    arrs = [m["_hota"] for m in per_seq.values()]
    tp = sum(a["HOTA_TP"] for a in arrs)
    out = {
        "alphas": arrs[0]["alphas"],
        "HOTA_TP": tp,
        "HOTA_FN": sum(a["HOTA_FN"] for a in arrs),
        "HOTA_FP": sum(a["HOTA_FP"] for a in arrs),
        "LocA_sum": sum(a["LocA_sum"] for a in arrs),
    }
    for key in ("AssA_alpha", "AssRe_alpha", "AssPr_alpha"):
        out[key] = sum(a[key] * a["HOTA_TP"] for a in arrs) \
            / np.maximum(1.0, tp)
    return _hota_final_fields(out)


def evaluate_mot16(gt_path: str, res_path: str, iou_thr: float = 0.5,
                   preprocess: bool = True, benchmark: str = "MOT16",
                   hota: bool = True,
                   keep_hota_arrays: bool = False) -> Dict[str, float]:
    """Score a MOT16 result file against a real 9-column gt.txt with
    TrackEval-exact semantics: MotChallenge2DBox preprocessing (distractor-
    matched tracker-det removal, zero-mark + pedestrian gt filter, crowd
    exclusion) followed by CLEAR + Identity — the `run_mot_challenge.py
    --METRICS CLEAR Identity` role of ref MOT16_eval/eval.sh:107-109 — plus
    native HOTA (beyond the reference's metric set; TRACKING_EVAL.md:3
    promises it "soon")."""
    hyp = load_mot_frames(res_path)
    if preprocess:
        gt, hyp = preprocess_mot(load_mot_gt(gt_path), hyp,
                                 benchmark=benchmark)
    else:
        gt = load_mot_frames(gt_path)
    out = evaluate_clear_identity(gt, hyp, iou_thr=iou_thr)
    if hota:
        out.update(evaluate_hota(gt, hyp))
        if not keep_hota_arrays:
            # the raw per-alpha numpy arrays are not JSON-serializable;
            # callers that pool across sequences (combine_sequences_hota)
            # opt in with keep_hota_arrays=True
            out.pop("_hota", None)
    return out
