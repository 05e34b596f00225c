"""The control of the correctness check, and its readings on the card.

The control is the reference put in the program's place with the one
guarantee the configurations state broken: its field is GF(2^8) under
the polynomial 0x11b (AES's) instead of 0x11d, as a kernel built from
the wrong multiplication table would compute it.  It runs through the
harness exactly as the program does (the same working set, stored
parity made by its own encode, the same loop and sample), and the check
must find it wrong.  The benchmark's own runs never run it.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 2

prints one JSON line per seed with the numbers compared.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from portbench import reference, spec
from portbench.run import run_cell

CONTROL_POLY = 0x11B


class ControlCode:
    """`encode_batch` / `decode_batch_full` by the reference over the
    control's field."""

    def __init__(self, cell: spec.Cell, device):
        profile = cell.config["profile"]
        self.k, self.m = int(profile["k"]), int(profile["m"])
        self.poly = CONTROL_POLY
        self.gen = reference.generator(profile["technique"], self.k, self.m,
                                       self.poly)

    def encode_batch(self, data: torch.Tensor) -> torch.Tensor:
        return reference.encode(self.gen, data, self.poly)

    def decode_batch_full(self, erasures, data: torch.Tensor) -> torch.Tensor:
        idx, rows = reference.decode_rows(self.gen, self.k, list(erasures),
                                          self.poly)
        return reference.product(rows, data[:, idx].contiguous(), self.poly)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.resolve(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_cell(cell, seed, args.seconds, False, device,
                       make_code=ControlCode)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
