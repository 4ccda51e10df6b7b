"""The numbers that decide `correct`, each a gap between what the program
produced and what the plain reference computes from the same weights and
inputs, and their judgement against a cell's limits."""

from __future__ import annotations

import math
import statistics

# a leaf whose reference gradient norm is below this share of the median
# leaf's moves under Adam by rounding alone: it is left out of the change
STILL_LEAF = 1e-3


def _gap(prog: float, ref: float, floor: float) -> float:
    return abs(prog - ref) / max(abs(ref), floor)


def image_gaps(got, want) -> tuple[list, list]:
    """Per image, (max |d|, rms d) over its reference logits' rms; infinite
    where the program's output lacks rows or pixels."""
    if tuple(got.shape) != tuple(want.shape):
        return [math.inf] * want.shape[0], [math.inf] * want.shape[0]
    diff = (got.float() - want.to(got.device)).flatten(1)
    rms = want.to(got.device).flatten(1).square().mean(1).sqrt().clamp(min=1e-12)
    return ((diff.abs().amax(1) / rms).tolist(), (diff.square().mean(1).sqrt() / rms).tolist())


def logit_gaps(got, want) -> tuple[float, float]:
    """(widest max |d|, widest rms d) of an image (`image_gaps`)."""
    peak, rms = image_gaps(got, want)
    return max(peak), max(rms)


def train_numbers(prog: dict, ref: dict) -> dict:
    """prog, ref: {"losses": [step losses], "grad": {leaf: norm of the first
    gradient}, "change": {leaf: norm of the change over the compared
    steps}, "logits": the first step's output}. Returns the first step's
    logit gaps (`logit_gaps`), the relative gap of the first step's loss
    and the widest over the steps; over the leaves that move (`STILL_LEAF`), the
    widest gap of a leaf's gradient norm and of its change norm, each
    against the larger of the leaf's reference norm and the median leaf's,
    and the median leaf's gaps, which small leaves' rounding noise does not
    set."""
    return {k: v for k, (v, _) in train_gaps(prog, ref).items()}


def train_gaps(prog: dict, ref: dict) -> dict:
    """`train_numbers` with, beside each, the step or leaf that sets it."""
    loss = max((_gap(p, r, 0.0), i) for i, (p, r) in enumerate(zip(prog["losses"],
                                                                   ref["losses"])))
    g_med = statistics.median(ref["grad"].values())
    moving = [n for n, g in ref["grad"].items() if g >= STILL_LEAF * g_med]
    grads = sorted((_gap(prog["grad"][n], ref["grad"][n], g_med), n) for n in moving)
    c_med = statistics.median(ref["change"][n] for n in moving)
    changes = sorted((_gap(prog["change"][n], ref["change"][n], c_med), n) for n in moving)
    mid = len(moving) // 2
    logit, logit_rms = logit_gaps(prog["logits"], ref["logits"])
    loss1 = _gap(prog["losses"][0], ref["losses"][0], 0.0)
    return {"logit_gap": (logit, 0), "logit_rms_gap": (logit_rms, 0), "loss1_gap": (loss1, 0),
            "loss_gap": loss, "grad_gap": grads[-1], "grad_median_gap": grads[mid],
            "change_gap": changes[-1], "change_median_gap": changes[mid]}


def serve_numbers(prog: dict, ref: dict) -> dict:
    """prog: {"losses": [(pool batch, loss) for every call of the window],
    "logits": {pool batch: (B, K, H, W) logits of one sampled call}}; ref:
    {"losses": {pool batch: loss}, "logits": {pool batch: logits}}. Returns
    the widest relative loss gap over every call; over the sampled calls'
    images (`image_gaps`), the widest logit gap, the widest and the median
    rms gap, and the share of pixels whose thresholded prediction
    differs."""
    loss = max(_gap(v, ref["losses"][b], 0.0) for b, v in prog["losses"])
    peak, rms, flips, pixels = [], [], 0, 0
    for b, got in prog["logits"].items():
        want = ref["logits"][b].to(got.device)
        g1, g2 = image_gaps(got, want)
        peak, rms = peak + g1, rms + g2
        if got.shape == want.shape:
            flips += int(((got > 0) != (want > 0)).sum())
        else:
            flips += want.numel()
        pixels += want.numel()
    return {"loss_gap": loss, "logit_gap": max(peak), "logit_rms_gap": max(rms),
            "logit_rms_median_gap": statistics.median(rms),
            "pred_mismatch": flips / max(pixels, 1)}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number present, finite and at or under its limit."""
    import math

    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())


