"""The comparison that decides ``correct``: numbers against their limits.

A training cell compares, step by step from one start, the program's run
with the reference's: each step's loss, the first gradient as the
optimizer received it (its first moment after one step over 1 - b1), and
each parameter leaf's change after the steps. Gradients and changes are
taken leaf by leaf as the gap between the two sides' norms, over the
reference's norm of that leaf or of the median leaf, whichever is larger;
leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding: Adam moves them by round-off alone) are left
out of both. A serving cell compares answers one by one.
"""

from __future__ import annotations

import contextlib
import statistics

import torch

NEGLIGIBLE = 1e-3


def leaf_gaps(prog: dict, ref: dict, keep: list) -> tuple[float, str]:
    """Worst (gap of norms over max(reference norm, median reference
    norm), leaf) over the leaves ``keep``."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keep}
    med = statistics.median(rn.values())
    worst, leaf = 0.0, ""
    for k in keep:
        gap = abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30)
        if gap >= worst:
            worst, leaf = gap, k
    return worst, leaf


def counted_leaves(ref_grads: dict) -> list:
    """Leaves whose reference gradient norm is at least NEGLIGIBLE of the
    median leaf's."""
    norms = {k: float(torch.linalg.vector_norm(g.double())) for k, g in ref_grads.items()}
    med = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= NEGLIGIBLE * med and n > 0]


def training_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: ``losses`` (per step), ``grad1`` (leaf -> first
    gradient), ``start`` and ``end`` (leaf -> parameters). Returns the
    compared numbers with the leaf that set each. The loss is compared at
    the first step: a later step's loss moves with the elements whose
    gradient is rounding, which Adam's first steps move by a whole learning
    rate either way; every step's gap is reported beside it."""
    keep = counted_leaves(ref["grad1"])
    steps = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog["losses"], ref["losses"])]
    grad, grad_leaf = leaf_gaps(prog["grad1"], ref["grad1"], keep)
    dp = {k: prog["end"][k] - prog["start"][k] for k in keep}
    dr = {k: ref["end"][k] - ref["start"][k] for k in keep}
    change, change_leaf = leaf_gaps(dp, dr, keep)
    return {"loss_step1": steps[0], "grad": grad, "change": change,
            "_details": {"grad": grad_leaf, "change": change_leaf, "loss_steps": steps,
                        "counted": len(keep), "of": len(ref["grad1"])}}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}); a
    number that is missing or not finite fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and abs(value) != float("inf") \
            and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out


@contextlib.contextmanager
def tf32():
    """Matmuls and convolutions in TF32 inside the block: the control's
    precision, the step below the float32 with TF32 off that the
    configurations state."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
