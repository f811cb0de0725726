#!/usr/bin/env python3
"""fused_select's K sweep on the card, for the port package of one checkout.

    python3 tools/select_sweep.py [--root DIR] [--out FILE] [--sass FILE]

Builds `DIR/funny_lidar_slam_torch/csrc/fused_select.cu` (DIR defaults to
this checkout) and times that kernel on the inputs of `chip_smoke.py`'s
phases 3 and 3c: K = 1, 2, 4, 8, 16 on the grid inputs and on the hashed
inputs, and the fitness shape (K=1, Gp=N). Each shape is first held
against the plain version (`chip_smoke.assert_parity`). Prints the card
line and one JSON line, also written to FILE if given.

With --sass, writes the library's SASS (`cuobjdump -sass`) to FILE and
adds to the JSON line the instructions of each plane's round loop: the
loop that closes with a backward branch around the two REDUX.MIN of a
round.

The inputs always come from this checkout's `chip_smoke.py`, so two runs
with different roots time two kernels on the same data. To compare a
commit with its parent on one card, unpack the parent into a gitignored
directory and run parent, change, change, parent in one command.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def round_loops(sass: str) -> dict:
    """{template argument (CPT): {"loop", "common"}} for each
    fused_select_kernel in `cuobjdump -sass` output. "loop" counts the
    instructions from the target of the backward branch whose body holds
    two REDUX.MIN to that branch; "common" leaves out the blocks that a
    forward branch inside the loop skips (the refresh of the lanes' two
    smallest keys), so it is a round that refreshes nothing."""
    out = {}
    for func in re.split(r"\n\s*Function : ", sass)[1:]:
        name = re.search(r"fused_select_kernelILi(\d+)E", func.split("\n", 1)[0])
        if not name:
            continue
        code = [(int(m.group(1), 16), m.group(2)) for m in
                re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", func)]
        jumps = [(a, int(m.group(1), 16)) for a, i in code
                 if (m := re.search(r"BRA (0x[0-9a-f]+)", i))]
        for end, start in jumps:
            body = [(a, i) for a, i in code if start <= a <= end]
            if start < end and sum("REDUX.MIN" in i for _, i in body) == 2:
                skipped = {a for a, _ in body for src, dst in jumps
                           if start < src < a < dst <= end}
                out[name.group(1)] = {"loop": len(body), "common": len(body) - len(skipped)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE, help="checkout whose port package is timed")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--sass", default=None, help="write the kernel's SASS here")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)  # the package under test
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    card = smoke.phase_device(torch)
    from funny_lidar_slam_torch.io.simulator import SimConfig, simulate
    from funny_lidar_slam_torch.ops import cuda_build, select

    assert os.path.dirname(os.path.dirname(select.__file__)) == os.path.join(
        root, "funny_lidar_slam_torch"), select.__file__
    built, = cuda_build.build_all(['fused_select']).values()  # keyed by name or (name, ())
    smoke.log(f"[sweep] {root}: {built.strip()}")
    grid = smoke.grid_select_inputs(torch, np.random.default_rng(7))
    ds = simulate(SimConfig(duration=10.0, points_per_scan=16384, seed=7))
    _, hashed, fitness, counts = smoke.hashed_select_inputs(torch, ds)
    for inputs, k in ((grid, 16), (hashed, 16), (fitness, 1)):
        out_k, out_p, qs = smoke.run_both(torch, select, inputs, k, "nearby26")
        smoke.assert_parity(out_k, out_p, qs)

    res = {"root": root, "card": card, "hashed_inputs": counts,
           "grid": smoke.k_sweep(torch, select, grid),
           "hashed": smoke.k_sweep(torch, select, hashed)}
    before = select.fused_select.launches
    fit = [smoke.time_ms(torch, lambda: select.fused_select(
        *fitness[:3], 1, 64, stencil="nearby26", qvox=fitness[3]), 50) for _ in range(4)]
    select.fused_select.launches = before
    res["fitness_k1"] = {"ms": float(np.median(fit)), "turns": fit}
    if args.sass:
        tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
        sass = subprocess.run([tool, "-sass", str(cuda_build.lib_path("fused_select"))],
                              capture_output=True, text=True, check=True).stdout
        with open(args.sass, "w") as f:
            f.write(sass)
        res["round_loop_instructions_by_cpt"] = round_loops(sass)
    line = json.dumps(res)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(card)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
