"""The port's copy of the MOT metrics (`reid_tpu_torch.tracking.metrics`)
against `reid_tpu.tracking.metrics`, exactly, on seeded 9-column gt and
result files with every row kind `preprocess_mot` handles: pedestrians,
zero-marked rows, distractor classes (with MOT20's non_mot_vehicle), the
crowd class, and tracker boxes that match distractors."""

import numpy as np
import pytest

from reid_tpu.tracking import metrics as jm
from reid_tpu_torch.tracking import metrics as tm


def write_sequence(root, seed, n_frames=30, n_ids=12):
    """A gt.txt and a noisy result file of one sequence."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 500, n_ids)
    y0 = rng.uniform(0, 300, n_ids)
    vx = rng.normal(0, 4, n_ids)
    w = rng.uniform(20, 60, n_ids)
    h = w * rng.uniform(1.8, 2.6, n_ids)
    cls = rng.choice([1, 1, 1, 1, 1, 2, 6, 7, 8, 12, 13], n_ids)
    gt, res = [], []
    for f in range(1, n_frames + 1):
        for i in range(n_ids):
            if rng.random() < 0.1:
                continue
            x, y = x0[i] + vx[i] * f, y0[i]
            flag = 0 if rng.random() < 0.08 else 1
            vis = rng.uniform(0, 1)
            gt.append(f"{f},{i + 1},{x:.2f},{y:.2f},{w[i]:.2f},{h[i]:.2f},"
                      f"{flag},{cls[i]},{vis:.3f}")
            if rng.random() < 0.85:
                # ids swap now and then; the tracker also follows distractors
                tid = i + 1 if rng.random() > 0.05 else (i + 1) % n_ids + 1
                j = rng.normal(0, 3, 4)
                res.append(f"{f},{tid},{x + j[0]:.2f},{y + j[1]:.2f},"
                           f"{w[i] + j[2]:.2f},{h[i] + j[3]:.2f},1,-1,-1,-1")
        for _ in range(rng.integers(0, 3)):                 # false positives
            res.append(f"{f},{100 + rng.integers(0, 5)},"
                       f"{rng.uniform(0, 600):.2f},{rng.uniform(0, 300):.2f},"
                       "30.00,70.00,1,-1,-1,-1")
    gt_path, res_path = root / f"gt{seed}.txt", root / f"res{seed}.txt"
    gt_path.write_text("\n".join(gt) + "\n")
    res_path.write_text("\n".join(res) + "\n")
    return str(gt_path), str(res_path)


def assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            assert_same(a[k], b[k])
        elif isinstance(a[k], tuple):
            assert_same(dict(enumerate(a[k])), dict(enumerate(b[k])))
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("benchmark", ["MOT16", "MOT20"])
def test_evaluate_mot16_equals_reference(tmp_path, benchmark):
    per_t, per_j = {}, {}
    for seed in (0, 1):
        gt, res = write_sequence(tmp_path, seed)
        per_t[seed] = tm.evaluate_mot16(gt, res, benchmark=benchmark,
                                        keep_hota_arrays=True)
        per_j[seed] = jm.evaluate_mot16(gt, res, benchmark=benchmark,
                                        keep_hota_arrays=True)
        assert_same(per_t[seed], per_j[seed])
        assert per_t[seed]["TP"] > 50 and per_t[seed]["IDSW"] > 0
    assert_same(tm.combine_sequences(per_t), jm.combine_sequences(per_j))
    assert_same(tm.combine_sequences_hota(per_t),
                jm.combine_sequences_hota(per_j))


def test_preprocess_and_parts_equal_reference(tmp_path):
    gt, res = write_sequence(tmp_path, 2)
    assert_same(tm.load_mot_gt(gt), jm.load_mot_gt(gt))
    hyp_t, hyp_j = tm.load_mot_frames(res), jm.load_mot_frames(res)
    assert_same(hyp_t, hyp_j)
    for benchmark in ("MOT16", "MOT20"):
        g_t, h_t = tm.preprocess_mot(tm.load_mot_gt(gt), hyp_t,
                                     benchmark=benchmark)
        g_j, h_j = jm.preprocess_mot(jm.load_mot_gt(gt), hyp_j,
                                     benchmark=benchmark)
        assert_same(g_t, g_j)
        assert_same(h_t, h_j)
        assert sum(len(v[1]) for v in h_t.values()) < sum(
            len(v[1]) for v in hyp_t.values())      # distractor dets gone
        assert_same(tm.evaluate_clear_identity(g_t, h_t),
                    jm.evaluate_clear_identity(g_j, h_j))
        assert_same(tm.evaluate_hota(g_t, h_t), jm.evaluate_hota(g_j, h_j))
    assert tm.MOT20_DISTRACTOR_CLASSES == jm.MOT20_DISTRACTOR_CLASSES
