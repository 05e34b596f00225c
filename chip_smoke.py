#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port: the erasure-code data path on one card.

    python3 chip_smoke.py          # from the repository root, one CUDA card

Phases, each failing the run (non-zero exit) on any error or mismatch:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ceph_tpu_torch/ec/kernels/csrc and print
   ptxas's registers and stack frame for each (from the log kept beside
   the library, so a cached build is checked too); a kernel with a stack
   frame (accumulators pushed to local memory) fails the run;
3. K1 (gf_matmul_cuda) against its plain PyTorch version over
   S x N x (r, k) sweeps with random matrices, r = 1 .. 8 and 10 rows,
   ragged and unaligned inputs included;
4. K2 (gf_decode_select_cuda) against its plain version over every 1-
   and 2-erasure pattern of k=8 m=4, with garbage in the erased slots;
5. the main path at full width through the user entry points: the `tpu`
   plugin k=8 m=4 reed_sol_van on cuda, one 1 MiB object through
   encode() against the numpy oracle, then 256 stripes of 1 MiB through
   encode_batch, decode_batch and decode_batch_full (erasures [1, 9]) and
   an ECUtil encode -> lose 2 shards -> decode_concat round trip.
   Kernel launch counts are zeroed before and read after; a kernel that
   the path did not launch fails the run;
6. time encode, staged decode and full-width decode (CUDA events, warmup,
   median of 7) and each kernel beside its plain version and its bound;
   K1 at both of its main-path shapes (encode r=4, staged decode r=2).

Integer outputs are compared exactly (tolerance 0).  The last two lines
are the kernel table and {"ok": true, "device": {...}}, both JSON.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
K, M = 8, 4
OBJECT = 1 << 20                 # 1 MiB objects
CHUNK = OBJECT // K              # 131072 B
STRIPES = 256                    # stripes per launch, as bench.py
ERASURES = [1, 9]
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
INT8_OPS_PER_S = 1.979e15        # H100 SXM dense int8 peak


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, repeats: int = 7) -> float:
    """Median over `repeats` of the mean time of `reps` calls, CUDA
    events around each group, after a warmup."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item()) \
        if a.numel() else 0


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` whose data pointer is 1 byte off 16."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    off = (16 - buf.data_ptr() % 16) % 16 + 1
    out = buf[off:off + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def check_k1(bm, gen: torch.Generator, dev) -> int:
    worst = 0
    cases = 0
    for (r, k), s, n in itertools.product(
            [(4, 8), (2, 8), (3, 5), (4, 20), (10, 6), (1, 8), (5, 8),
             (6, 8), (7, 8), (8, 8)], [1, 3, 4, 7],
            [1, 31, 4096, CHUNK + 17]):
        mat = torch.randint(0, 256, (r, k), generator=gen, device=dev,
                            dtype=torch.uint8)
        tables = torch.from_numpy(
            bm.packed_nibble_tables(mat.cpu().numpy())).to(dev)
        data = torch.randint(0, 256, (s, k, n), generator=gen, device=dev,
                             dtype=torch.uint8)
        want = bm.gf_matmul_plain(mat, data)
        for d in (data, unaligned_copy(data)) if n == 4096 else (data,):
            err = max_err(bm.gf_matmul_cuda(tables, d, r), want)
            if err:
                raise AssertionError(f"K1 differs at r={r} k={k} S={s} "
                                     f"N={n} ptr%16={d.data_ptr() % 16}")
            worst = max(worst, err)
            cases += 1
    torch.cuda.synchronize()
    print(f"phase 3: K1 == plain on {cases} cases (max_abs_err {worst})")
    return worst


def check_k2(bm, ec, make_decode_matrix_full, gen: torch.Generator,
             dev) -> int:
    n = K + M
    s, nbytes = 3, 4096 + 5
    worst = 0
    patterns = [list(p) for r in (1, 2) for p in itertools.combinations(range(n), r)]
    for erasures in patterns:
        decode_index = [i for i in range(n) if i not in erasures][:K]
        full = make_decode_matrix_full(ec.encode_matrix, K, n, decode_index,
                                       erasures)
        valid = np.ones(n, dtype=bool)
        valid[erasures] = False
        op = bm.GFDecodeFull(full, valid, dev)
        data = torch.randint(0, 256, (s, K, nbytes), generator=gen,
                             device=dev, dtype=torch.uint8)
        arrival = torch.cat([data, ec.encode_batch(data)], dim=1)
        want_rows = arrival[:, erasures].clone()
        arrival[:, erasures] = torch.randint(
            0, 256, (s, len(erasures), nbytes), generator=gen, device=dev,
            dtype=torch.uint8)
        got = bm.gf_decode_select_cuda(op.tables, op.sel_t, arrival)
        plain = bm.gf_decode_select_plain(op.mat_t, op.runs, arrival)
        err = max(max_err(got, plain), max_err(got, want_rows))
        if err:
            raise AssertionError(f"K2 differs for erasures {erasures}")
        worst = max(worst, err)
    torch.cuda.synchronize()
    print(f"phase 4: K2 == plain == lost rows on {len(patterns)} erasure "
          f"patterns (max_abs_err {worst})")
    return worst


def main_path(ec, ecutil, gf, gen: torch.Generator, dev) -> dict:
    """The full-width slice through the user entry points.  Returns the
    device tensors the timing phase reuses."""
    n = K + M
    rng = np.random.default_rng(SEED)
    obj = rng.integers(0, 256, OBJECT, dtype=np.uint8).tobytes()
    chunks = ec.encode(set(range(n)), obj)
    want = np.frombuffer(obj, dtype=np.uint8).reshape(K, CHUNK)
    want = np.concatenate([want, gf.gf_matmul_bytes(ec.encode_matrix[K:], want)])
    for i in range(n):
        if not np.array_equal(chunks[i], want[i]):
            raise AssertionError(f"encode() chunk {i} differs from the oracle")

    data = torch.randint(0, 256, (STRIPES, K, CHUNK), generator=gen,
                         device=dev, dtype=torch.uint8)
    parity = ec.encode_batch(data)
    full = torch.cat([data, parity], dim=1)
    decode_index = [i for i in range(n) if i not in ERASURES][:K]
    survivors = full[:, decode_index].contiguous()
    lost = full[:, ERASURES].clone()
    staged = ec.decode_batch(decode_index, ERASURES, survivors)
    arrival = full.clone()
    arrival[:, ERASURES] = 0xA5              # garbage in the erased slots
    rebuilt = ec.decode_batch_full(ERASURES, arrival)
    if not torch.equal(staged, lost) or not torch.equal(rebuilt, lost):
        raise AssertionError("decode did not rebuild chunks 1 and 9")

    sinfo = ecutil.StripeInfo(K, K * CHUNK)
    logical = data.cpu().numpy().tobytes()
    t_encode = []                 # first call, then a repeat
    for _ in range(2):
        t0 = time.monotonic()
        shards = ecutil.encode(sinfo, ec, logical)
        t_encode.append(time.monotonic() - t0)
    for i in range(K, n):
        if shards[i] != parity[:, i - K].cpu().numpy().tobytes():
            raise AssertionError(f"ecutil.encode shard {i} differs")
    degraded = {i: v for i, v in shards.items() if i not in ERASURES}
    t_decode = []
    for _ in range(2):
        timings = {}
        t0 = time.monotonic()
        rebuilt_object = ecutil.decode_concat(sinfo, ec, degraded, timings)
        t_decode.append(time.monotonic() - t0)
    if rebuilt_object != logical:
        raise AssertionError("ecutil decode_concat round trip differs")
    torch.cuda.synchronize()
    stage = timings["stage"][1] - timings["stage"][0]
    kernel = timings["kernel"][1] - timings["kernel"][0]
    def ms(ts):
        return " then ".join(f"{t * 1e3:.1f}" for t in ts)
    print(f"phase 5: ecutil host clock, {len(logical)} B, first call then "
          f"repeat: encode {ms(t_encode)} ms, decode_concat {ms(t_decode)} "
          f"ms (repeat: survivor stack {stage * 1e3:.1f} ms, copy in + "
          f"kernel + copy back {kernel * 1e3:.1f} ms)")
    return {"data": data, "parity": parity, "survivors": survivors,
            "arrival": arrival, "decode_index": decode_index,
            "staged": staged, "rebuilt": rebuilt}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ceph_tpu_torch.ec import gf, registry
    from ceph_tpu_torch.ec.kernels import _build
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.ec.matrix_code import (make_decode_matrix,
                                               make_decode_matrix_full)
    from ceph_tpu_torch.osd import ecutil

    t_start = time.monotonic()
    name_power = card()
    print(name_power)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    t0 = time.monotonic()
    log = _build.build("gf_matmul")["gf_matmul"]
    print(f"phase 2: built gf_matmul in {time.monotonic() - t0:.1f} s")
    if "stack frame" not in log:
        raise AssertionError("no ptxas report for gf_matmul")
    for line in log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.replace("ptxas info    :", "").strip())
        frame = re.search(r"(\d+) bytes stack frame", line)
        if frame and int(frame.group(1)):
            raise AssertionError(f"a kernel has a stack frame: {line.strip()}")

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    err_k1 = check_k1(bm, gen, dev)
    ec = registry.factory("tpu", {"k": str(K), "m": str(M),
                                  "technique": "reed_sol_van"})
    err_k2 = check_k2(bm, ec, make_decode_matrix_full, gen, dev)

    bm.reset_launches()
    state = main_path(ec, ecutil, gf, gen, dev)
    launches = dict(bm.LAUNCHES)
    print(f"phase 5: main path k={K} m={M} chunk={CHUNK} stripes={STRIPES} "
          f"ok; launches {launches}")
    for kname, count in launches.items():
        if count == 0:
            raise AssertionError(f"main path never launched {kname}")

    # -- the main path's outputs against the plain versions, full width --
    data, parity = state["data"], state["parity"]
    survivors, arrival = state["survivors"], state["arrival"]
    di = state["decode_index"]
    n = K + M
    enc_op = ec._encode_mm
    dec_op = bm.GFMatmul(make_decode_matrix(ec.encode_matrix, K, di,
                                            ERASURES), dev)
    valid = np.array([i not in ERASURES for i in range(n)])
    full_op = bm.GFDecodeFull(make_decode_matrix_full(
        ec.encode_matrix, K, n, di, ERASURES), valid, dev)
    err_k1 = max(err_k1,
                 max_err(parity, bm.gf_matmul_plain(enc_op.mat_t, data)),
                 max_err(state["staged"],
                         bm.gf_matmul_plain(dec_op.mat_t, survivors)))
    err_k2 = max(err_k2, max_err(state["rebuilt"], bm.gf_decode_select_plain(
        full_op.mat_t, full_op.runs, arrival)))
    print(f"phase 5: main-path outputs == plain versions at full width "
          f"(max_abs_err K1 {err_k1}, K2 {err_k2})")
    if err_k1 or err_k2:
        raise AssertionError("a kernel disagrees with its plain version")

    # -- phase 6: timing ------------------------------------------------
    obj_bytes = STRIPES * K * CHUNK
    t_enc = time_ms(lambda: ec.encode_batch(data))
    t_dec = time_ms(lambda: ec.decode_batch(di, ERASURES, survivors))
    t_full = time_ms(lambda: ec.decode_batch_full(ERASURES, arrival))
    for label, t in (("encode", t_enc), ("decode_staged", t_dec),
                     ("decode_full", t_full)):
        print(f"phase 6: {label} {obj_bytes / t / 1e3:.1f} MB/s "
              f"({t:.4f} ms per {STRIPES} x 1 MiB) on {name_power}")

    def bound(nbytes: int, ops: int) -> tuple[float, str]:
        tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    k1_ms = time_ms(lambda: bm.gf_matmul_cuda(enc_op.tables, data, M))
    k1_plain = time_ms(lambda: bm.gf_matmul_plain(enc_op.mat_t, data),
                       reps=2, repeats=5)
    k1_dec_ms = time_ms(lambda: bm.gf_matmul_cuda(dec_op.tables, survivors,
                                                  len(ERASURES)))
    k2_ms = time_ms(lambda: bm.gf_decode_select_cuda(
        full_op.tables, full_op.sel_t, arrival))
    k2_plain = time_ms(lambda: bm.gf_decode_select_plain(
        full_op.mat_t, full_op.runs, arrival), reps=2, repeats=5)
    r_enc, r_dec = M, len(ERASURES)
    k1_bound, k1_by = bound(STRIPES * (K + r_enc) * CHUNK,
                            STRIPES * r_enc * K * CHUNK)
    k1_dec_bound, _ = bound(STRIPES * (K + r_dec) * CHUNK,
                            STRIPES * r_dec * K * CHUNK)
    k2_bound, k2_by = bound(STRIPES * (K + r_dec) * CHUNK,
                            STRIPES * r_dec * K * CHUNK)
    print(f"phase 6: K1 encode {k1_ms:.4f} ms (bound {k1_bound:.4f}), "
          f"K1 staged decode {k1_dec_ms:.4f} ms (bound {k1_dec_bound:.4f}), "
          f"K2 {k2_ms:.4f} ms (bound {k2_bound:.4f}) on {name_power}")

    kernels = [
        {"name": "gf_matmul", "route": "cuda",
         "source": "ceph_tpu_torch/ec/kernels/csrc/gf_matmul.cu",
         "replaces": "ceph_tpu/ec/kernels/bitmatmul.py:185",
         "launches": launches["gf_matmul"], "max_abs_err": err_k1,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None,
         "staged_decode_ms": k1_dec_ms,
         "staged_decode_bound_ms": k1_dec_bound},
        {"name": "gf_decode_select", "route": "cuda",
         "source": "ceph_tpu_torch/ec/kernels/csrc/gf_matmul.cu",
         "replaces": "ceph_tpu/ec/kernels/bitmatmul.py:302",
         "launches": launches["gf_decode_select"], "max_abs_err": err_k2,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    print(f"chip_smoke: {time.monotonic() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
