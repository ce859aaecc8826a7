#!/usr/bin/env python3
"""Time ``chip_smoke.py``'s train phase (the flagship LM's step through
``make_train_step -> init_state -> step``: Adam, bf16, batch 8 x 2048) in
two checkouts, in turns, on one card.

    python3 tools/train_step_ab.py OTHER_CHECKOUT [--rounds N]

Runs the train phase of OTHER_CHECKOUT ("other") and of this checkout
("this") in child processes, in the order other, this, this, other (N
times), each from its own directory so that each imports its own
``mxnet_tpu_torch`` and builds its own kernels there. Prints each run's
step line (median of 10 timed steps after 2 warm), its kernel-time
profile by kind, and the medians of each side. Write OTHER_CHECKOUT with
``git archive`` into a gitignored directory (``build/``), e.g.
``mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent``:
the card's machine has no git. Needs a CUDA card and nvcc; imports no
JAX.
"""
from __future__ import annotations

import argparse
import os
import re
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
sys.path.insert(0, ".")
import chip_smoke
import mxnet_tpu_torch
from mxnet_tpu_torch import _kernels
from mxnet_tpu_torch.ops import attention as att
_kernels.build()
chip_smoke.train_phase([att.flash_fwd_cuda, att.flash_bwd_cuda])
"""


def run(label, cwd):
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=cwd,
                          capture_output=True, text=True, timeout=600)
    out = proc.stdout
    if proc.returncode != 0:
        sys.exit("%s (%s) failed, exit %d:\n%s\n%s" % (
            label, cwd, proc.returncode, out[-3000:], proc.stderr[-3000:]))
    m = re.search(r"train: step ([0-9.]+) ms", out)
    lines = [ln for ln in out.splitlines()
             if ln.startswith(("train: step", "profile: train step",
                               "profile:   by kind"))]
    print("%s: %s" % (label, " | ".join(lines)), flush=True)
    return float(m.group(1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="a checkout to compare with this one")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    if not os.path.isfile(os.path.join(other, "chip_smoke.py")):
        sys.exit("%s holds no chip_smoke.py" % other)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    times = {"other": [], "this": []}
    for _ in range(args.rounds):
        for label in ("other", "this", "this", "other"):
            times[label].append(run(label, other if label == "other"
                                    else HERE))
    for label, ts in times.items():
        print("%s: step ms %s, median %.2f" % (
            label, " ".join("%.2f" % t for t in ts), statistics.median(ts)))


if __name__ == "__main__":
    main()
