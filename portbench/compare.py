"""The numbers that decide ``correct``, each a gap between what the timed
path produced and the plain reference.

Training (first three steps, the same rows, weights and generators):
- ``loss_gap``: the largest |loss − reference loss| / |reference loss| of the steps;
- ``grad_gap``: over leaves, the largest gap between the norms of the
  first clipped gradient (the program's from its Adam state after one step)
  and the reference's, over the larger of that leaf's reference norm and
  the median leaf's (a leaf whose gradient is all but zero would read any
  gap over its own; the median leaf is a vector, so a fault on a bias or a
  small head still reads about 1);
- ``update_gap``: the same for the parameters' change after the three
  steps, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (a leaf with a gradient nought to
  rounding, such as a key bias under softmax, moves under Adam by
  round-off alone).

Serving (a sample of the window's answers, the longest request in it):
- ``prob_gap``: the largest |probability − reference probability|.
  Valence and arousal are read beside it (``va_gap``: the largest gap over
  the sample's median reference magnitude) but not compared: the control
  does not separate from sound runs by it (see PERF.md).
"""
import numpy as np


def _leaf_gap(prog, ref, names):
    r = np.array([ref[n] for n in names])
    p = np.array([prog[n] for n in names])
    scale = np.maximum(r, np.median(r))
    gaps = np.abs(p - r) / np.where(scale > 0, scale, 1.0)
    i = int(np.argmax(gaps))
    return float(gaps[i]), names[i]


def train(prog, ref):
    """prog/ref: {"loss": [..], "grad": {name: norm}, "delta": {name: norm}};
    ref also "raw_grad". → ({number: value}, [info lines])."""
    lp, lr = np.array(prog["loss"]), np.array(ref["loss"])
    loss_gap = float(np.max(np.abs(lp - lr) / np.abs(lr)))
    names = sorted(ref["grad"])
    grad_gap, worst_g = _leaf_gap(prog["grad"], ref["grad"], names)
    raw = np.array([ref["raw_grad"][n] for n in names])
    moving = [n for n, g in zip(names, raw) if g >= 1e-3 * np.median(raw)]
    update_gap, worst_u = _leaf_gap(prog["delta"], ref["delta"], moving)
    info = [f"losses program {prog['loss']} reference {ref['loss']}",
            f"grad_gap worst leaf {worst_g}: program {prog['grad'][worst_g]!r} "
            f"reference {ref['grad'][worst_g]!r}",
            f"update_gap worst leaf {worst_u}: program {prog['delta'][worst_u]!r} "
            f"reference {ref['delta'][worst_u]!r}; {len(names) - len(moving)} of {len(names)} "
            f"leaves left out (reference gradient under 1e-3 of the median leaf's)"]
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "update_gap": update_gap}, info


def serve(prog, ref):
    """prog/ref: lists of {"probs": [7], "valence": v, "arousal": a}, aligned."""
    pp = np.array([a["probs"] for a in prog])
    rp = np.array([a["probs"] for a in ref])
    prob_gap = float(np.max(np.abs(pp - rp)))
    pv = np.array([[a["valence"], a["arousal"]] for a in prog])
    rv = np.array([[a["valence"], a["arousal"]] for a in ref])
    scale = float(np.median(np.abs(rv).max(axis=1))) or 1.0
    va_gap = float(np.max(np.abs(pv - rv)) / scale)
    return {"prob_gap": prob_gap}, [
        f"serve check over {len(prog)} answers; va_gap {va_gap!r} (not compared) over the "
        f"valence/arousal scale {scale!r}"]
