"""Binomial (revolve) checkpoint scheduling for adjoint sweeps.

Long time marches cannot store every forward state for the reverse sweep;
the classical answer is binomial checkpointing (Griewank–Walther revolve):
with ``s`` checkpoint slots and ``t`` allowed repetitions, up to C(s+t, s)
steps can be reversed. Counterpart of the JAX package's
``adjoint/checkpointing.py`` (host code only, copied: that module cannot be
imported without jax).

The planner is the native one (``native/revolve.cpp``, built to
``native/librevolve.so`` at the root of the checkout and loaded with
ctypes) when that library is there, and otherwise the Python planner below.
Both emit the same schedule, byte for byte (tested against each other and
against the JAX package's planner), so the Python planner is no device
fallback: planning is host work, once per adjoint configuration.

Actions: ("advance", n) | ("takeshot", slot) | ("restore", slot) |
("reverse", 1).
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path

__all__ = [
    "max_steps",
    "min_repetitions",
    "plan_schedule",
    "optimal_snaps",
    "simulate_schedule",
    "native_available",
]

# the native planner of this checkout (make -C native); never the JAX
# package's installed copy
NATIVE_LIB = Path(__file__).resolve().parents[2] / "native" / "librevolve.so"


@lru_cache(maxsize=1)
def _load_native():
    if not NATIVE_LIB.exists():
        return None
    try:
        lib = ctypes.CDLL(str(NATIVE_LIB))
    except OSError:  # built for another platform: plan in Python
        return None
    i64 = ctypes.c_int64
    lib.aoa_plan.restype = i64
    lib.aoa_plan.argtypes = [i64, i64, ctypes.POINTER(i64), i64]
    lib.aoa_binomial_reps.restype = i64
    lib.aoa_binomial_reps.argtypes = [i64, i64]
    lib.aoa_max_steps.restype = i64
    lib.aoa_max_steps.argtypes = [i64, i64]
    return lib


def native_available() -> bool:
    return _load_native() is not None


def max_steps(snaps: int, reps: int) -> int:
    """Largest step count reversible with ``snaps`` slots, ``reps`` sweeps."""
    lib = _load_native()
    if lib is not None:
        return int(lib.aoa_max_steps(snaps, reps))
    return math.comb(snaps + reps, snaps)


def min_repetitions(steps: int, snaps: int) -> int:
    """Minimal repetition count t with C(s+t, s) ≥ steps."""
    lib = _load_native()
    if lib is not None:
        return int(lib.aoa_binomial_reps(steps, snaps))
    if steps <= 1:
        return 0
    t = 0
    while math.comb(snaps + t, snaps) < steps:
        t += 1
    return t


def optimal_snaps(steps: int, budget_states: int | None = None) -> int:
    """A good default slot count: ~log2(steps) slots reach t≈log(steps)
    repetitions; capped by an optional memory budget."""
    s = max(2, int(math.log2(max(steps, 2))))
    if budget_states is not None:
        s = min(s, budget_states)
    return s


_ACTION_NAMES = {0: "advance", 1: "takeshot", 2: "restore", 4: "reverse"}


def _plan_py(steps: int, snaps: int) -> list[tuple[str, int]]:
    """Binomial schedule via the η(s,t) = η(s,t−1) + η(s−1,t−1) recurrence:
    snapshot the base, advance m = n − η(s−1, t−1) (clamped), reverse the
    right part with s−1 free slots, restore, reverse the left part with the
    slot freed. t is recomputed locally, keeping the budget self-consistent
    for any n."""
    acts: list[tuple[str, int]] = []

    def rec(n: int, slot0: int, s: int, t: int):
        if n == 0:
            return
        if n == 1:
            acts.append(("reverse", 1))
            return
        if s == 0:
            raise ValueError("checkpoint slots exhausted — infeasible plan")
        if s == 1:
            # one slot: quadratic sweep from the pinned base
            acts.append(("takeshot", slot0))
            for j in range(n - 1, -1, -1):
                if j > 0:
                    acts.append(("advance", j))
                acts.append(("reverse", 1))
                if j > 0:
                    acts.append(("restore", slot0))
            return
        if n <= s + 1:
            # enough slots for a single-pass reversal (t = 1)
            for j in range(n - 1):
                acts.append(("takeshot", slot0 + j))
                acts.append(("advance", 1))
            acts.append(("reverse", 1))
            for j in range(n - 2, -1, -1):
                acts.append(("restore", slot0 + j))
                acts.append(("reverse", 1))
            return
        # keep t minimal-feasible for the subproblem
        t = max(t, 1)
        while math.comb(s + t, s) < n:
            t += 1
        while t > 1 and math.comb(s + t - 1, s) >= n:
            t -= 1
        # Griewank–Walther split along η(s,t) = η(s,t−1) + η(s−1,t):
        # advance m, reverse the RIGHT n−m steps with s−1 free slots and
        # the SAME t (they are traversed once now and recursed within),
        # then restore and reverse the LEFT m steps with all s slots and
        # t−1 (each left step just spent one of its traversals). Feasible
        # iff n−m ≤ η(s−1, t) and m ≤ η(s, t−1); the greedy
        # m = n − η(s−1, t) meets both. (A round-≤4 version recursed the
        # right part with t−1 and advanced n − η(s−1, t−1): still a VALID
        # schedule — slots/order verified — but Θ(n²/s) forwards instead
        # of the binomial ~t·n bound; the K=10⁵ revolve bench measured
        # the 4.4×-recompute smell that exposed it.)
        m = max(1, min(n - 1, n - math.comb(s - 1 + t, s - 1)))
        m = min(m, math.comb(s + t - 1, s))
        acts.append(("takeshot", slot0))
        acts.append(("advance", m))
        rec(n - m, slot0 + 1, s - 1, t)
        acts.append(("restore", slot0))
        rec(m, slot0, s, t - 1)

    t0 = min_repetitions(steps, snaps)
    rec(steps, 0, snaps, max(t0, 1))
    return acts


def plan_schedule(steps: int, snaps: int) -> list[tuple[str, int]]:
    """The checkpointing action schedule for ``steps`` steps / ``snaps``
    slots (native planner when built, Python fallback otherwise — they emit
    identical schedules)."""
    lib = _load_native()
    if lib is None:
        return _plan_py(steps, snaps)
    cap = 16
    while True:
        buf = (ctypes.c_int64 * (2 * cap))()
        n = int(lib.aoa_plan(steps, snaps, buf, cap))
        if n >= 0:
            return [(_ACTION_NAMES[buf[2 * i]], int(buf[2 * i + 1])) for i in range(n)]
        cap = -n


def simulate_schedule(steps: int, snaps: int, schedule=None) -> dict:
    """Validate a schedule by simulation. Returns stats:
    {'forward_steps': recomputation count, 'max_slots': peak slots used}.
    Raises AssertionError on an invalid reversal order."""
    # `or` would silently replace an explicitly passed EMPTY schedule (the
    # thing a validator most needs to reject) with a fresh correct plan
    schedule = schedule if schedule is not None else plan_schedule(steps, snaps)
    pos = 0
    slots: dict[int, int] = {}
    next_reverse = steps  # we must reverse steps in order steps-1 ... 0
    fwd = 0
    for act, arg in schedule:
        if act == "advance":
            pos += arg
            fwd += arg
        elif act == "takeshot":
            slots[arg] = pos
            assert len(slots) <= snaps, "slot budget exceeded"
        elif act == "restore":
            pos = slots[arg]
        elif act == "reverse":
            assert pos == next_reverse - 1, (
                f"reverse at pos {pos}, expected {next_reverse - 1}"
            )
            next_reverse -= 1
        else:  # pragma: no cover
            raise ValueError(act)
        assert 0 <= pos <= steps
    assert next_reverse == 0, f"{next_reverse} steps never reversed"
    return {"forward_steps": fwd, "max_slots": len(slots)}
