"""Seed/config sweep launcher — the replacement for the TACC SLURM job farm
(python/Submit_schedule_frontera/).

Counterpart of the JAX package's ``drivers/sweep.py``; its commands launch
this package's drivers. The reference farms independent (seed, config)
runs one-per-GPU via generated argument files + `launcher paramrun`, 4
concurrent jobs per node (Submit_schedule_frontera/main_serial.sh:38-44,
main_shell.sh:10-14). Independent runs need no communication, so the
equivalent is simply N processes. This module generates the command list
(like Generating_argurment_files.py) and can execute them locally,
sequentially or ``--parallel N`` at a time — each process gets
``SWEEP_SLOT`` in its environment (the analogue of the reference's
per-process ``CUDA_VISIBLE_DEVICES`` pinning, e.g. Main_new_loss.py:14) so
a run can pin itself to a device by slot.

Usage:
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.sweep \
        --driver train_resnet_ode --seeds 5 6 7 8 \
        --extra "--method variable_params --epochs 100" --run --parallel 4
    python -m adjoint_ode_adaptivity_tpu_torch.drivers.sweep \
        --driver fd_adaptive --seeds 1 2 --extra "--device cpu" --run --parallel 2
"""
from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import time


def generate_commands(
    driver: str,
    seeds: list[int],
    extra: str,
    checkpoint_root: str | None = None,
) -> list[str]:
    """One command per seed. ``checkpoint_root`` appends a PER-SEED
    ``--checkpoint-dir {root}/seed_{s}`` (every adaptive/training driver
    accepts it and auto-resumes from it), so concurrent seeds never share a
    checkpoint directory and a ``--retries`` requeue genuinely resumes."""
    base = f"{sys.executable} -m adjoint_ode_adaptivity_tpu_torch.drivers.{driver}"
    cmds = [f"{base} --seed {s} {extra}".strip() for s in seeds]
    if checkpoint_root:
        cmds = [
            f"{c} --checkpoint-dir {os.path.join(checkpoint_root, f'seed_{s}')}"
            for c, s in zip(cmds, seeds)
        ]
    return cmds


def run_commands(
    cmds: list[str],
    parallel: int = 1,
    check: bool = True,
    retries: int = 0,
) -> list[int]:
    """Execute ``cmds`` with at most ``parallel`` concurrent processes.

    A simple slot scheduler: slot ``i`` exports ``SWEEP_SLOT=i`` to its
    process (device-pinning hook). Returns the list of return codes in
    command order; raises on the first nonzero code when ``check`` (after
    draining the running slots).

    ``retries`` adds the failure recovery the reference farm lacks (its
    only failure tooling is the manual ``scancel.sh``,
    Submit_schedule_frontera/scancel.sh:1-7 — a died job restarts by hand):
    a run exiting nonzero is requeued up to ``retries`` times. Requeued
    attempts resume from a checkpoint only when the command carries a
    ``--checkpoint-dir`` (use ``generate_commands(checkpoint_root=...)`` /
    ``--checkpoint-root`` for per-seed directories); otherwise they restart
    from scratch. ``SWEEP_ATTEMPT`` (0-based attempt counter) is exported
    purely as information for the run. The recorded return code is the
    final attempt's.
    """
    parallel = max(1, int(parallel))
    retries = max(0, int(retries))
    codes: list[int | None] = [None] * len(cmds)
    attempts = [0] * len(cmds)
    running: dict[int, tuple[int, subprocess.Popen]] = {}  # slot -> (idx, proc)
    free = list(range(parallel))[::-1]
    pending = list(enumerate(cmds))[::-1]

    def _reap(block: bool) -> None:
        # poll-with-sleep, never wait() on one specific child: a slot freed
        # by ANY finished job must be reusable immediately (waiting on an
        # arbitrary long-running job would idle freed slots behind it and
        # degenerate the farm toward serial execution)
        while running:
            done = [s for s, (_, pr) in running.items() if pr.poll() is not None]
            if done:
                for s in done:
                    idx, pr = running.pop(s)
                    rc = pr.returncode
                    if rc != 0 and attempts[idx] < retries:
                        attempts[idx] += 1
                        print(
                            f"==> FAILED (rc={rc}) attempt {attempts[idx]}/"
                            f"{retries + 1}, requeueing: {cmds[idx]}"
                        )
                        pending.append((idx, cmds[idx]))
                    else:
                        codes[idx] = rc
                    free.append(s)
                return
            if not block:
                return
            time.sleep(0.05)

    while pending or running:
        if not pending or not free:
            _reap(block=True)
            continue
        idx, c = pending.pop()
        slot = free.pop()
        print(f"==> [slot {slot}] {c}")
        env = dict(
            os.environ, SWEEP_SLOT=str(slot), SWEEP_ATTEMPT=str(attempts[idx])
        )
        try:
            running[slot] = (idx, subprocess.Popen(shlex.split(c), env=env))
        except OSError as e:
            # launch failure (missing binary, bad command): route through
            # the same requeue/record path as a nonzero exit instead of
            # aborting mid-drain with children still running
            free.append(slot)
            if attempts[idx] < retries:
                attempts[idx] += 1
                print(
                    f"==> LAUNCH FAILED ({e}) attempt {attempts[idx]}/"
                    f"{retries + 1}, requeueing: {c}"
                )
                pending.append((idx, c))
            else:
                print(f"==> LAUNCH FAILED ({e}): {c}")
                codes[idx] = 127
    out = [int(c) for c in codes]  # type: ignore[arg-type]
    failed = [(cmds[i], rc) for i, rc in enumerate(out) if rc != 0]
    if failed:
        print(f"==> {len(failed)}/{len(cmds)} runs failed after retries:")
        for c, rc in failed:
            print(f"==>   rc={rc}: {c}")
    if check and failed:
        raise subprocess.CalledProcessError(failed[0][1], failed[0][0])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--driver", default="train_resnet_ode")
    p.add_argument("--seeds", type=int, nargs="+", default=[5, 6, 7, 8])
    p.add_argument("--extra", default="", help="extra args passed to each run")
    p.add_argument("--out", default=None, help="write the command file here")
    p.add_argument("--run", action="store_true", help="execute the commands")
    p.add_argument(
        "--parallel", type=int, default=1,
        help="max concurrent runs (reference farm: 4 per node)",
    )
    p.add_argument(
        "--retries", type=int, default=0,
        help="requeue a failed run up to N times (SWEEP_ATTEMPT exported)",
    )
    p.add_argument(
        "--checkpoint-root", default=None,
        help="per-seed --checkpoint-dir ROOT/seed_S on every command, so "
             "retried runs resume instead of restarting",
    )
    args = p.parse_args(argv)

    cmds = generate_commands(
        args.driver, args.seeds, args.extra,
        checkpoint_root=args.checkpoint_root,
    )
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(cmds) + "\n")
        print(f"wrote {len(cmds)} commands to {args.out}")
    else:
        for c in cmds:
            print(c)
    if args.run:
        run_commands(cmds, parallel=args.parallel, retries=args.retries)
    return cmds


if __name__ == "__main__":
    main()
