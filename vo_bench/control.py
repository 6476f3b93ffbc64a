#!/usr/bin/env python3
"""Readings for the limits of `correct`: the program and its controls.

    python3 vo_bench/control.py --workload <cell> --seeds 11 12 13 --seconds 40

For each seed, one run of the cell as `run.py` makes it (in this one
process), then the controls, judged by the same numbers:

- the plain reference put in the program's place and computed in
  bfloat16, the precision below the float32 that the configuration states
  for its kernels (`reference.control`);
- the reference with the guarantees that each pose follows the camera's
  motion and that the map lies on the scene broken (`reference.frozen`);
- each planted fault of `FAULTS`: the program run again with that fault
  in it, for FAULT_SECONDS (the map it reads was built under the fault
  from the first frame on, through the whole warm-up).

Prints one JSON line per seed with every set of numbers, and appends it
to `--out` (default `vo_bench/out/control.jsonl`). Needs the card, as
run.py does.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import run


def _ba_dropped():
    """Local BA returns its state unchanged: the write-back of every
    solve writes nothing to the map."""
    from plsvo_torch.parallel import ba

    orig = ba.write_back_window
    ba.write_back_window = lambda *args, **kw: (0, 0)

    def undo():
        ba.write_back_window = orig
    return undo


FAULTS = {"ba_dropped": _ba_dropped}
# a fault run's window: its map numbers read the map the warm-up built
FAULT_SECONDS = 10.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=str(run.HERE / "out" / "control.jsonl"))
    a = ap.parse_args(argv)
    import torch

    from vobench import reference

    if not torch.cuda.is_available():
        print("control.py: no CUDA card", file=sys.stderr)
        return 2
    manifest = run.load_manifest()
    for seed in a.seeds:
        keep = {}
        res, got = run.run_cell(manifest, a.workload, seed, a.seconds, False,
                                "cuda:0", t_start=time.perf_counter(),
                                keep=keep)
        out, truth = keep["out"], keep["truth"]
        rec = {"workload": a.workload, "seed": seed, "correct": res["correct"],
               "metrics": res["metrics"], "program": got,
               "control": reference.numbers(reference.control(out, truth),
                                            truth),
               "frozen": reference.numbers(reference.frozen(out, truth), truth)}
        del keep, out
        for name in sorted(FAULTS):
            undo = FAULTS[name]()
            try:
                fres, fgot = run.run_cell(manifest, a.workload, seed,
                                          FAULT_SECONDS, False, "cuda:0",
                                          t_start=time.perf_counter())
                rec[name] = dict(fgot, correct=fres["correct"])
            except Exception as e:  # a fault that crashes gives no number
                rec[name] = {"error": repr(e)}
            finally:
                undo()
        line = json.dumps(rec)
        print(line, flush=True)
        path = Path(a.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
