"""The readings that the limits of a cell's comparison are set from.

    python3 -m cfbench.control --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --out readings.jsonl

For each seed, as a run makes them: the cell's log, the program's
set-up (its first epoch, as a run's set-up drives it) and a short window
(``WINDOW_S``), and the plain reference's first epoch and the window's
last epoch in float32: the numbers that ``run.py`` compares (the sound
readings). For each control seed also the control and the faults of
both epochs, each in the program's place against the float32 reference:
the reference in bfloat16 (the precision below the configuration's
float32), the reference with half of each chunk left out and the rest
weighted double, and the state left unchanged. Prints each seed's
readings as a JSON line and, at the end, the largest sound and the least
control reading of each number. Runs on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

FAULTS = (("bfloat16", dict(dtype=torch.bfloat16)),
          ("half", dict(fault="half")))
# the window before the compared window epoch: a few epochs at the cells'
# sizes, so that its index is past set-up's
WINDOW_S = 2.0


def seed_readings(cell, seed: int, device, control: bool,
                  repeat: bool = False) -> dict:
    from cfbench import harness as hz
    log = hz.make_log(cell, seed, device)
    t = time.perf_counter()
    model, start, first = hz.program_setup(cell, log, seed, device, [])
    attempted, failed, _, error, kept = hz.window(
        model, WINDOW_S, device, cell.program.state)
    assert not failed, error
    before, end = hz.window_leaves(cell, model, kept)
    del kept
    hz.free_program(model, device)
    t_prog = time.perf_counter() - t
    last = hz.SETUP_EPOCHS + attempted
    runs = {"": ({}, {"epoch": last, "tables": before})}
    if repeat:
        # the reference against itself: a second run, whose index_add_
        # sums in another order on the card
        runs["reference_again"] = runs[""]
    if control:
        for name, kw in FAULTS:
            runs[name] = ({**kw}, {"epoch": last, "tables": before, **kw})
    names = list(runs)
    got = hz.reference_epochs(cell, log, seed, device,
                              [kw for n in names for kw in runs[n]])
    pairs = {n: got[2 * k:2 * k + 2] for k, n in enumerate(names)}
    (r0, r1), (_, rw) = pairs[""]

    def numbers(p0, p1, w0, w1):
        out = hz.readings(cell, log, seed, device, p0, p1, r0, r1)
        out.update(hz.window_numbers(hz.readings(
            cell, log, seed, device, w0, w1, before, rw)))
        return out

    out = {"seed": seed, "window_epoch": last,
           "program": numbers(start, first, before, end),
           "program_s": t_prog,
           "reference_s": time.perf_counter() - t - t_prog}
    for n in names[1:]:
        (c0, c1), (w0, w1) = pairs[n]
        out[n] = numbers(c0, c1, w0, w1)
    if control:
        out["unchanged"] = numbers(r0, r0, before, before)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--repeat", action="store_true",
                    help="also run the reference a second time and read "
                         "it against the first")
    args = ap.parse_args(argv)
    from cfbench import harness as hz
    cell = hz.Cell(hz.load_spec(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | ctrl):
        row = seed_readings(cell, seed, "cuda", seed in ctrl, args.repeat)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    for number in rows[0]["program"]:
        if not number.endswith("_gap"):
            continue
        sound = max(r["program"][number] for r in rows)
        least = {k: min(r[k][number] for r in rows if k in r)
                 for k in ("bfloat16", "half", "unchanged")
                 if any(k in r for r in rows)}
        print(f"{number}: lower {sound!r} (largest of {len(rows)} sound "
              f"seeds); upper readings {least}", file=sys.stderr)
    found = hz.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
