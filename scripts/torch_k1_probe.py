#!/usr/bin/env python3
"""K1 (`gf_matmul_k1`) of the PyTorch/CUDA port on one CUDA card, beside a
device copy of its bytes, and its SASS per input byte.

    python3 scripts/torch_k1_probe.py [--out PATH]   # from the repository root

1. Times K1 (`gf_matmul_cuda`) at the main path's width, S=256 stripes of
   k=8 rows of 131072 B, for r=4 (encode), r=2 (staged decode) and r=8,
   each beside its HBM bound and beside a device-to-device copy that
   moves as many bytes (read and written), the yardstick of what the
   card's memory reaches.  The two alternate in rounds (mean of 20
   launches per sample, CUDA events, median of the rounds).
2. Disassembles the built library with cuobjdump and counts the SASS
   instructions of each K1 kernel's 16-byte-load loop per input byte.

Prints the card's name and power limit first; writes everything as JSON to
--out (default ceph_tpu_torch/_build/k1_probe.json).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ceph_tpu_torch.ec.kernels import _build  # noqa: E402
from ceph_tpu_torch.ec.kernels import bitmatmul as bm  # noqa: E402

SEED = 20261016
S, K, N = 256, 8, 131072
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
ROUNDS = 9


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def sample_ms(fn, reps: int = 20) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sass_loop_counts(lib_path: Path, bytes_per_iter: int) -> dict:
    """Instructions in each K1 kernel's innermost loop that holds a 16-byte
    global load and shared-memory lookups, by opcode, and per input
    byte."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    result = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        if "gf_k1_kernel" not in name:
            continue
        width = "W=4" if "ILi4E" in name else "W=8"
        instrs, labels, pending = [], {}, []
        for line in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", line)
            if lab:
                pending.append(lab.group(1))
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if ins:
                addr = int(ins.group(1), 16)
                labels.update({lb: addr for lb in pending})
                pending = []
                instrs.append((addr, ins.group(2)))
        loops = []
        for addr, ins in instrs:
            br = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))",
                           ins)
            if not br:
                continue
            tgt = labels.get(br.group(1)) if br.group(1) else \
                int(br.group(2), 16)
            if tgt is not None and tgt <= addr:
                loop = [i for a, i in instrs if tgt <= a <= addr]
                if any("LDG.E.128" in i for i in loop) and \
                        any(i.startswith("LDS") or " LDS" in i for i in loop):
                    loops.append(loop)
        if not loops:
            result[width] = {"error": "no loop with a 16-byte load found"}
            continue
        loop = min(loops, key=len)
        ops = Counter(re.sub(r"^@!?U?P\w+\s+", "", i).split()[0].split(".")[0]
                      for i in loop)
        result[width] = {"instructions": len(loop),
                         "per_input_byte": len(loop) / bytes_per_iter,
                         "opcodes": dict(ops.most_common())}
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "k1_probe.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k1_probe: no CUDA device; nothing was run",
              file=sys.stderr)
        return 2
    name_power = smi("name,power.limit")
    print(name_power)
    dev = torch.device("cuda", 0)
    report: dict = {"card": name_power, "k1": {}, "device copy": {}}

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    data = torch.randint(0, 256, (S, K, N), generator=gen, device=dev,
                         dtype=torch.uint8)
    rng = np.random.default_rng(SEED)
    shapes = {}                  # r -> (tables, plain matrix)
    copies = {}                  # r -> (src, dst) moving S*(K+r)*N bytes
    for r in (4, 2, 8):
        mat = rng.integers(0, 256, (r, K), dtype=np.uint8)
        shapes[r] = (torch.from_numpy(bm.packed_nibble_tables(mat)).to(dev),
                     torch.from_numpy(mat).to(dev))
        half = S * (K + r) * N // 2
        copies[r] = (torch.empty(half, dtype=torch.uint8, device=dev),
                     torch.empty(half, dtype=torch.uint8, device=dev))
    for r, (tables, mat) in shapes.items():
        if not torch.equal(bm.gf_matmul_cuda(tables, data, r),
                           bm.gf_matmul_plain(mat, data)):
            raise AssertionError(f"K1 differs from its plain version, r={r}")

    samples = {(what, r): [] for what in ("k1", "device copy")
               for r in shapes}
    clocks = []
    for _ in range(ROUNDS):
        for r, (tables, _) in shapes.items():
            fn = lambda: bm.gf_matmul_cuda(tables, data, r)  # noqa: E731
            fn()
            samples[("k1", r)].append(sample_ms(fn))
            src, dst = copies[r]
            samples[("device copy", r)].append(
                sample_ms(lambda: dst.copy_(src)))
        clocks.append(smi("clocks.sm,clocks.max.sm,power.draw"))
    report["clocks_sm_max_power_draw"] = clocks
    for (what, r), ts in samples.items():
        bound = S * (K + r) * N / HBM_BYTES_PER_S * 1e3
        ms = statistics.median(ts)
        report[what][f"r={r}"] = {"ms": ms, "bound_ms": bound,
                                  "share_of_bound": bound / ms,
                                  "samples_ms": ts}
        print(f"{what}: r={r} {ms:.4f} ms (bound {bound:.4f}, share "
              f"{bound / ms:.2f}; samples {min(ts):.4f}-{max(ts):.4f})")
    print(f"clocks.sm, clocks.max.sm, power.draw per round: {clocks}")

    src = (_build.CSRC / "gf_matmul.cu").read_text()
    per_iter = int(re.search(r"constexpr int kK1Group = (\d+);",
                             src).group(1)) * \
        int(re.search(r"constexpr int kK1Bytes = (\d+);", src).group(1))
    sass = sass_loop_counts(_build.lib_path("gf_matmul"), per_iter)
    report["sass_k1_loop"] = sass
    for width, info in sass.items():
        print(f"SASS {width}: {json.dumps(info)}")

    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
