"""ceph_erasure_code_benchmark-compatible CLI.

Flags and output format follow the reference harness
(ref: src/test/erasure-code/ceph_erasure_code_benchmark.cc:40-139 options,
:151-181 encode loop, :246-312 decode loop): prints "seconds\tKiB" and, on
decode, byte-verifies the reconstructed chunks against the originals
(ref: :220-231).

The port's copy of `ceph_tpu.tools.ec_bench`, on the port's registry:
the plugin's kernels run on the card by default, on the CPU with
`--device cpu`.  The input bytes and the erasure patterns come from the
same seed as the reference CLI's.

Example:
    python -m ceph_tpu_torch.tools.ec_bench --plugin tpu --workload encode \
        --size $((1024*1024)) --iterations 64 --parameter k=8 --parameter m=4
"""
from __future__ import annotations

import argparse
import itertools
import sys
import time

import numpy as np

from ..ec import registry


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="ec_bench")
    p.add_argument("--plugin", "-P", default="jerasure")
    p.add_argument("--workload", "-w", default="encode",
                   choices=["encode", "decode"])
    p.add_argument("--size", "-s", type=int, default=1 << 20,
                   help="total size in bytes per iteration")
    p.add_argument("--iterations", "-i", type=int, default=1)
    p.add_argument("--erasures", "-e", type=int, default=1)
    p.add_argument("--erasures-generation", "-S", default="random",
                   choices=["random", "exhaustive"])
    p.add_argument("--erased", type=int, action="append", default=None,
                   help="explicit chunk index to erase (repeatable)")
    p.add_argument("--parameter", "-p", action="append", default=[],
                   help="k=v plugin profile parameter (repeatable)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the plugin's kernels run (default: the "
                        "CUDA card; raises without one)")
    p.add_argument("--verbose", "-v", action="store_true")
    return p.parse_args(argv)


def _choose_erasures(n: int, count: int, mode: str, explicit, rng):
    if explicit:
        yield tuple(explicit)
        return
    if mode == "exhaustive":
        yield from itertools.combinations(range(n), count)
    else:
        while True:
            yield tuple(sorted(rng.choice(n, size=count, replace=False)))


def run(args) -> float:
    profile = {}
    for kv in args.parameter:
        key, _, val = kv.partition("=")
        profile[key] = val
    ec = registry.factory(args.plugin, profile, device=args.device)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    rng = np.random.default_rng(795)
    data = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()
    want_all = set(range(n))

    if args.workload == "encode":
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            ec.encode(want_all, data)
        elapsed = time.perf_counter() - t0
    else:
        encoded = ec.encode(want_all, data)
        gen = _choose_erasures(n, args.erasures, args.erasures_generation,
                               args.erased, rng)
        elapsed = 0.0
        done = 0
        for erasures in gen:
            if done >= args.iterations:
                break
            avail = {i: c for i, c in encoded.items() if i not in erasures}
            t0 = time.perf_counter()
            decoded = ec.decode(want_all, avail)
            elapsed += time.perf_counter() - t0
            # correctness gate (ref: ceph_erasure_code_benchmark.cc:220-231)
            for i in range(n):
                if not np.array_equal(decoded[i], encoded[i]):
                    raise SystemExit(f"chunk {i} differs after decode "
                                     f"(erasures={erasures})")
            done += 1

    kib = args.size / 1024 * args.iterations
    print(f"{elapsed:f}\t{kib:.0f}")
    return elapsed


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
