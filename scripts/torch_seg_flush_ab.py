#!/usr/bin/env python3
"""Time what kernel J's atomic flush costs on one card, in turns.

    python3 scripts/torch_seg_flush_ab.py

Kernel J (lightgbm_tpu_torch/csrc/seg_hist.cu) ends each run of a CTA's
share by adding its int32 shared-memory histogram into the output with
one device-memory atomicAdd a nonzero word.  This script builds a copy
of this tree's package under build/seg_flush_off/ whose seg_hist.cu
flushes nothing (each run keeps one guarded store that never fires, so
the row loop and its shared adds stay live; its output is wrong and is
not checked), and times J's three cases of scripts/torch_hist_ab.py
(the leaf partition of 1,000,000 rows of 28 groups of 63 bins at a
tree's first round, W=126 and all 255 leaves) with the flush off, on,
on, off, each in its own process, by CUDA events and by device time.
The difference is the flush's cost: the most that any other flush
(copies stored and summed by another launch, say) could save.  Prints
the card's name and power limit and writes
chiprun_out/seg_flush_ab.json.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OFF_ROOT = os.path.join(HERE, "build", "seg_flush_off")

# (text of seg_hist.cu, what the flush-off copy puts in its place)
PATCHES = (
    ("      for (int i = tid; i < slot_words; i += nt)\n"
     "        if (src[i]) atomicAdd(dst + i, src[i]);\n",
     "      if (tid == 0 && src[0] == (int32_t)0x80000000) dst[0] = src[1];\n"),
)


def build_off_tree() -> str:
    """Copy the package to OFF_ROOT and cut its kernel J's flush; raises
    if a patched text is missing from seg_hist.cu."""
    dst = os.path.join(OFF_ROOT, "lightgbm_tpu_torch")
    shutil.rmtree(OFF_ROOT, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "lightgbm_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = os.path.join(dst, "csrc", "seg_hist.cu")
    with open(src) as fh:
        text = fh.read()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise RuntimeError(f"seg_hist.cu no longer holds:\n{old}")
        text = text.replace(old, new)
    with open(src, "w") as fh:
        fh.write(text)
    return OFF_ROOT


def main() -> int:
    spec = importlib.util.spec_from_file_location(
        "torch_hist_ab", os.path.join(HERE, "scripts", "torch_hist_ab.py"))
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    card = ab._chip_smoke().card_line()
    runs = ab._runs("--time-root", build_off_tree(),
                    ("--only", "J ", "--no-check"))
    if runs is None:
        return 1
    print(f"card: {card}")
    print(f"{'case':<22} {'flush off (run 1, 4)':>22} "
          f"{'flush on (run 2, 3)':>22}  flush ms")
    table = {}
    for case in runs[0][1]:
        off = [r[case] for lab, r in runs if lab == "parent"]
        on = [r[case] for lab, r in runs if lab == "change"]
        cost = np.mean(on) - np.mean(off)
        table[case] = {"flush off": off, "flush on": on, "flush_ms": cost}
        print(f"{case:<22} {off[0]:>10.4f} {off[1]:>10.4f}  {on[0]:>10.4f} "
              f"{on[1]:>10.4f}  {cost:.4f}")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "seg_flush_ab.json"),
              "w") as fh:
        json.dump(dict(card=card, cases=table), fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
