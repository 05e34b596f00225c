#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one card: the erasure-code data
path, CRUSH placement, compiled repair, the placement tools (crushtool,
osdmaptool and the upmap balancer), the device guard, the multi-device EC
mesh and its OSD-side fabric, the ceph_erasure_code_benchmark CLI, and the
EC placement group's data plane (ECBackend over MemStore).

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
   K1 at both of its main-path shapes (encode r=4, staged decode r=2);
7. K3 (crush_do_rule_cuda) against its plain PyTorch version: every rule
   shape of the batch engine's tests on small straw2 hierarchies under
   jewel and firefly tunables, all-in and 15 % out / 15 % partial
   weights, a choose_args weight set with id remaps, tie-heavy and
   many-weight flat buckets, and the 10,000-OSD map for the first 65,536
   seeds of both pools below; ptxas's registers and stack frame of K3;
8. CRUSH placement at full width through the user entry point:
   `osdmaptool --createsimple 10000 --test-map-pgs` (10,000 OSDs, 500
   straw2 hosts of 20, jewel tunables, 1,048,576 PGs of size 3) plus an
   EC k=8 m=4 pool (chooseleaf_indep 12 type host, 65,536 PGs), mapped by
   OSDMapMapping(device=cuda).update(); then a failure epoch (100 OSDs
   out, 100 reweighted to 0x8000, 50 down) and update() again.  Each
   epoch: 256 sampled PGs of each pool against the scalar
   pg_to_up_acting_osds, and the PGs per OSD.  K3's launch count is
   zeroed before and read after (it must be above 0); the count of pools
   that took the scalar engine must stay 0;
9. time K3 over 1,048,576 seeds (CUDA events), update() on the host
   clock and split into its pieces, and the plain version at 65,536
   seeds; K3's bound from the
   straw2 item evaluations the plain version counts over all 1,048,576
   seeds, the integer instructions of one hash in K3's SASS and the SM
   clock read during the timing;
10. compiled repair at full width through the user entry points:
   `factory("jerasure", k=4 m=2 reed_sol_van)`, `factory("clay", k=4
   m=2)` (d=5) and `factory("lrc", k=4 m=2 l=3)` on cuda, 64 objects of
   4 MiB each (stripe unit 4096 B, 256 stripes), made from the seed and
   encoded by ecutil on the host.  Shard 0 is lost; each object's helper
   buffers are cut as an OSD ships them (plan.byte_extents +
   ecutil.expand_stream_extents) and ecutil.compiled_repair_streams
   rebuilds it, twice; jerasure also rebuilds shards {1, 2} of every
   object.  On object 0, every single-erasure signature (jerasure: every
   double too) equals the original; one compile per signature; helper
   bytes read per byte rebuilt are 4.0 / 2.5 / 3.0.  Then clay k=6 m=3
   d=8 on one object (a 27 x 72 repair matrix) and gf2_matmul_device
   against bitmatrix_apply for liber8tion k=8, liberation k=7 w=7 and
   blaum_roth k=6 w=6 over 4 MiB of packets.  K1's launch count is
   zeroed before and read after: one launch per repair or bit-matrix
   product.  K1 equals its plain version at every repair shape, two
   with tables above 48 KiB (k_in 256 and 400) included;
11. time each code's rebuild of its 64 objects on the host clock, split
   into gather, copy in, K1 (also by CUDA events), copy back and
   scatter, with the rebuilt MB/s, beside the first (compiling) and
   second pass of phase 10; K1 per launch at each repair shape beside
   its bound ((k_in + r) * N bytes over 3.35 TB/s, or r * k_in * N
   operations at the int8 rate) and its plain version;
12. crushtool on the card, as Ceph's "Editing a CRUSH map" does it at the
   placement scale: `crushtool --build --num-osds 10000 host straw2 20
   root straw2 0`, `-d`, two rules appended (replicated_rule: chooseleaf
   firstn 0 type host; ec_k8m4: set_chooseleaf_tries 5, chooseleaf indep
   0 type host), `-c`, the decompile fixed point, then `-i --test
   --show-statistics --show-utilization` over x = 0 .. 1,048,575 for
   rule 0 at num_rep 3 and rule 1 at 12: one K3 launch per (rule,
   num_rep), no scalar fallback, every x of full size; K3 against the
   plain version on the card over every x of rule 0 and every 4th x of
   rule 1 (262,144 x over the whole range, cut to keep the smoke's wall
   time; rule 1's text is not held to the plain version), rule 0's text equal
   to the text of the plain version's tables, 256 sampled x equal to
   CrushWrapper.do_rule, and the text equal to CrushTester(device="cpu")'s
   at 1,024 x; K3 by CUDA events in the tool's run, and the split of one
   more run with each piece a lap of it (map load, then
   CrushTester.test's timings: compile_map, map_batch, copy back,
   counting and formatting);
13. the balancer: `osdmaptool --createsimple 10000 --osds-per-host 20
   --pg-num 1048576`, then `--upmap --upmap-max 10 --upmap-deviation 5
   --test-map-pgs` (the tool's defaults): two K3 launches (the
   balancer's update() and --test-map-pgs's), timed by CUDA events in
   that run; every upmapped PG on 3 hosts and equal to the scalar
   pg_to_up_acting_osds after the Incremental, Balancer.score()'s stddev
   lower after; the split of one more pass, each piece a lap of it
   (update, calc_pg_upmaps's timings: clone, _build_pgs_by_osd, search;
   apply_incremental, second update); then at 1,000 OSDs / 32,768 PGs
   the command file from the card equals the one from `--device cpu`;
14. the device guard (ceph_tpu_torch.common.devguard): first the host
   cost per call of K1's wrapper, the operator's launch() and the
   plugin's encode_batch with the guard off and on; then, armed, phase
   5's ECUtil round trip (and one on a fresh plugin, whose decode operator
   is built inside the guarded region), an OSDMapMapping.update() of
   phase 8's map, phase 10's compiled repair of one code (and one repair
   on a fresh instance of it, whose cache compiles the plan once) and
   phase 12's rule-0 test at 65,536 x, with no guard error and no
   recompile; then an `.item()` inside guard_transfers() must raise;
15. the multi-device EC mesh on one card (ceph_tpu_torch.dist.make_mesh(8,
   shard_ways=w, devices=["cuda:0"] * 8) for w = 1, 2, 4; K1 per grid
   position, the partials XORed per stripe row): phase 5's 256 x 1 MiB
   encode equal to encode_batch's parity and the plain version, the
   decode of [1, 9] at full width and all 66 two-erasure patterns at 16
   stripes equal to the lost chunks; K1's launch count zeroed before and
   read after (8 per mesh step); the mesh encode timed beside
   encode_batch, and K1 at the narrowest column slice ((128, 2, 131072)
   -> r=4) beside its bound and its plain version.  One card cannot show
   a launch on a card that is not the current device (the multi-card
   test in tests/test_torch_cuda.py does);
16. the fabric: ICIFabric(devices=["cuda:0"] * 8) with the `tpu` plugin
   on the card, 64 objects of 4 MiB (stripe unit 4096 B); 32 staged, then
   12 threads fetch every shard of those while 2 threads stage and fetch
   the other 32; every stream equal to ecutil.encode, nothing staged
   after release; each stage and fetch on the host clock;
17. the ceph_erasure_code_benchmark CLI (ceph_tpu_torch.tools.ec_bench) on
   the card for the tpu and isa plugins, k=8 m=4, 1 MiB x 64 iterations,
   encode and decode (random two-erasure patterns through its byte
   gate): seconds, KiB and MB/s;
18. the EC placement group's data plane (ceph_tpu_torch.osd.ec_backend:
   ECBackend and one ECPGShard per shard over the port's MemStores, wired
   directly) at the pool shape `tpu` k=8 m=4 reed_sol_van on the card,
   stripe unit 4096 B, 4 MiB objects: 64 objects written through
   submit_transaction, 100 KiB unaligned overwrites in 16 of them, every
   object read back equal to the script's bytes and every shard stream
   equal to ecutil.encode through a device="cpu" plugin (K1's plain
   version); shards 1 and 9 down and every object read degraded (K1's
   staged decode); shard 0 wiped and recovered through recover_object,
   one compiled repair (one K1 launch) per object and no full rebuild,
   equal to the streams from before, read/rebuilt exactly 8.0; the same
   recovery for REPAIR_r01.json's jerasure, clay and lrc (64 objects
   each, 4.0 / 2.5 / 3.0); the 64 writes again through ICIFabric over
   ["cuda:0"] * 8, every chunk equal to the host path's.  Write, read,
   degraded-read and rebuilt MB/s on the host clock, K1's CUDA-event
   share of each, and a split of one write (merge, ecutil.encode, the
   HashInfo crc32c, the transaction build, MemStore's apply).  K1's
   launch count is zeroed before and read after the phase.

Integer outputs are compared exactly (tolerance 0).  The last two lines
are the kernel table and {"ok": true, "device": {...}}, both JSON.
"""
from __future__ import annotations

import contextlib
import io
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

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
SMS, INT32_LANES = 132, 64       # H100 SXM: SMs, INT32 lanes per SM
N_OSD, OSDS_PER_HOST = 10_000, 20
PG_NUM, EC_PG_NUM = 1 << 20, 1 << 16
EC_K, EC_M = 8, 4
SAMPLE = 256                     # identity sample per pool, as placement_bench
PLAIN_SEEDS = 1 << 16
REPAIR_OBJECTS = 64
REPAIR_OBJECT = 4 << 20          # 4 MiB objects
STRIPE_UNIT = 4096               # osd_pool_erasure_code_stripe_unit default
REPAIR_CODES = [                 # REPAIR_r01.json's profiles and read/rebuilt
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}, 4.0),
    ("clay", {"k": "4", "m": "2"}, 2.5),
    ("lrc", {"k": "4", "m": "2", "l": "3"}, 3.0),
]
WIDE_CLAY = {"k": "6", "m": "3", "d": "8"}   # the corpus's wider clay profile
TOOL_TESTS = [(0, 3), (1, 12)]   # crushtool --test (rule, num_rep)
TOOL_X = 1 << 20                 # x = 0 .. 1,048,575
TOOL_SAMPLE = 256                # sampled x per rule against do_rule
TOOL_PLAIN_CHUNK = 1 << 18       # seeds per pass of the plain version there
# stride of the x held to the plain version per rule: every x of rule 0;
# every 4th x of rule 1 (the 12-wide indep rule, 8x rule 0's cost per x),
# 262,144 x spread over the whole launch, to keep the smoke's wall time
TOOL_PLAIN_STRIDE = {0: 1, 1: 4}
TOOL_GUARD_X = 1 << 16           # phase 14's guarded tester run
TOOL_CPU_X = 1 << 10             # text against CrushTester on the CPU
TOOL_RULES = """\
rule replicated_rule {
\tid 0
\ttype replicated
\tmin_size 1
\tmax_size 10
\tstep take root
\tstep chooseleaf firstn 0 type host
\tstep emit
}

rule ec_k8m4 {
\tid 1
\ttype erasure
\tmin_size 3
\tmax_size 12
\tstep set_chooseleaf_tries 5
\tstep take root
\tstep chooseleaf indep 0 type host
\tstep emit
}
"""
UPMAP_MAX, UPMAP_DEVIATION = 10, 5   # osdmaptool's --upmap defaults
# the card-against-CPU balancer map, cut from 65,536 PGs to keep phases
# 12-14 short (the CPU side is the plain version)
CROSS_OSD, CROSS_PG = 1000, 1 << 15
MESH_WAYS = (1, 2, 4)            # shard_ways of the one-card mesh
MESH_PATTERN_S = 16              # stripes per two-erasure pattern
FABRIC_OBJECTS = 64              # 4 MiB objects through the fabric
BENCH_ITERATIONS = 64            # ec_bench --iterations
SPIN_CYCLES = 4_000_000          # about 2 ms at the H100's 1980 MHz


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


def device_ms(fn, reps: int = 20, repeats: int = 7) -> float:
    """Like time_ms, but each group is queued behind a spin kernel of
    about 2 ms, so the card runs the launches back to back whatever the
    host's cost of launching them: the kernel's own time."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
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


# ---------------------------------------------------------------------------
# CRUSH placement: phases 7-9

def max_err32(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def ptxas_report(log: str, kernel: str) -> dict:
    """Registers, stack frame and spills of `kernel` from ptxas -v."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" not in line or kernel not in line:
            continue
        rest = lines[i + 1:]
        end = next((j for j, ln in enumerate(rest) if "Compiling entry" in ln),
                   len(rest))
        block = " ".join(rest[:end])
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", block)
        regs = re.search(r"Used (\d+) registers", block)
        if frame and regs:
            return {"registers": int(regs.group(1)),
                    "stack_frame_bytes": int(frame.group(1)),
                    "spill_store_bytes": int(frame.group(2)),
                    "spill_load_bytes": int(frame.group(3))}
    raise AssertionError(f"no ptxas report for {kernel}")


def sass_instructions(lib_path, function: str) -> int:
    """Instructions (NOPs aside) of one kernel in the library's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib_path)], check=True,
                          capture_output=True, text=True, timeout=300).stdout
    parts = re.split(r"^\s*Function : (\S+)\s*$", text, flags=re.M)
    for name, body in zip(parts[1::2], parts[2::2]):
        if name == function:
            ops = [m.group(1) for m in re.finditer(
                r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", body)]
            return sum(1 for op in ops if not op.startswith("NOP"))
    raise AssertionError(f"{function} not in the SASS of {lib_path}")


class ClockSampler:
    """The SM clock (MHz) read by nvidia-smi every 100 ms while the
    block runs; the process is stopped on exit."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        self.mhz = [int(v) for v in out.split() if v.strip().isdigit()]
        return False


def placement_map():
    """`osdmaptool --createsimple 10000`: 500 straw2 hosts of 20 OSDs
    under a straw2 root, jewel tunables, pool 0 of 1,048,576 PGs x 3;
    plus pool 1, EC k=8 m=4 (chooseleaf_indep 12 type host), 65,536 PGs."""
    from ceph_tpu_torch.crush.types import (CRUSH_RULE_CHOOSELEAF_INDEP,
                                            CRUSH_RULE_EMIT, CRUSH_RULE_TAKE,
                                            CrushRule, CrushRuleMask,
                                            CrushRuleStep)
    from ceph_tpu_torch.osd.osdmap import OSDMap
    from ceph_tpu_torch.osd.types import POOL_TYPE_ERASURE, PGPool
    m = OSDMap()
    m.build_simple(N_OSD, osds_per_host=OSDS_PER_HOST,
                   pg_pool=PGPool(pg_num=PG_NUM, pgp_num=PG_NUM, size=3))
    root = next(b.id for b in m.crush.buckets
                if b is not None and b.type == 10)
    size = EC_K + EC_M
    m.crush.rules.append(CrushRule(
        steps=[CrushRuleStep(CRUSH_RULE_TAKE, root),
               CrushRuleStep(CRUSH_RULE_CHOOSELEAF_INDEP, size, 1),
               CrushRuleStep(CRUSH_RULE_EMIT)],
        mask=CrushRuleMask(ruleset=1, type=POOL_TYPE_ERASURE, min_size=1,
                           max_size=16)))
    m.pools[1] = PGPool(type=POOL_TYPE_ERASURE, size=size,
                        min_size=EC_K + 1, crush_rule=1, pg_num=EC_PG_NUM,
                        pgp_num=EC_PG_NUM)
    m.pool_names[1] = "ecpool"
    return m


def check_k3(cb, ct, placement, dev) -> tuple[int, int]:
    """Phase 7: K3 against the plain version, exactly.  Returns
    (cases, max_abs_err)."""
    from ceph_tpu_torch.crush.types import ChooseArg, CrushRule
    rng = np.random.default_rng(SEED)
    worst = 0
    cases = 0

    def one(m, result_max, weight, xs, label, ruleno=0, choose_args=None,
            class_path=None):
        nonlocal worst, cases
        cc = cb.compile_map(m, choose_args=choose_args,
                            class_path=class_path, device=dev)
        cfg = cc.rule_cfg(ruleno, result_max)
        xs = torch.as_tensor(np.asarray(xs, dtype=np.int64), device=dev)
        weight = torch.as_tensor(np.asarray(weight, dtype=np.int64),
                                 device=dev)
        got, got_n = cb.crush_do_rule_cuda(cc, cfg, xs, weight)
        want, want_n = cb.map_batch_plain(cc, cfg, xs, weight)
        err = max(max_err32(got, want), max_err32(got_n, want_n))
        if err:
            raise AssertionError(f"K3 differs from plain: {label}")
        worst = max(worst, err)
        cases += 1

    seeds = rng.integers(0, 1 << 32, 4000, dtype=np.int64)
    for rule in ("replicated_firstn", "ec_indep", "two_level_firstn",
                 "direct_osd_indep", "direct_osd_firstn"):
        for tunables in ("jewel", "firefly"):
            m, root = ct.build_hierarchy(seed=cases, tunables=tunables)
            steps, result_max = ct.rule_shapes(root)[rule]
            m.rules.append(CrushRule(steps=steps))
            for weight in (np.full(m.max_devices, 0x10000),
                           ct.make_weight(m.max_devices, seed=cases)):
                one(m, result_max, weight, seeds, f"{rule} {tunables}")
    m, root = ct.build_hierarchy(seed=11)
    m.rules.append(CrushRule(steps=ct.rule_shapes(root)["ec_indep"][0]))
    rb = m.bucket(root)
    ca = {root: ChooseArg(
        ids=[i - 1000 for i in rb.items],
        weight_set=[[int(rng.integers(1, 8) * 0x10000) for _ in rb.items]
                    for _ in range(3)])}
    for class_path in (True, False):
        one(m, 6, ct.make_weight(m.max_devices, seed=5), seeds,
            "choose_args weight set", choose_args=ca, class_path=class_path)
        one(ct.build_flat([0xFFFF0000] * 20), 3, np.full(20, 0x10000),
            np.arange(20_000), "tie-heavy flat", class_path=class_path)
        n = cb.CLASS_PATH_MAX + 8
        one(ct.build_flat([0x10000 + i * 0x100 for i in range(n)]), 3,
            ct.make_weight(n, seed=3), seeds, "many weights",
            class_path=class_path)
    for pool_id, pool in placement.pools.items():
        ruleno = placement.crush.find_rule(pool.crush_rule, pool.type,
                                           pool.size)
        pps = pool.raw_pg_to_pps_batch(np.arange(PLAIN_SEEDS), pool_id)
        one(placement.crush, pool.size, placement.osd_weight, pps,
            f"10k map pool {pool_id}", ruleno=ruleno)
    torch.cuda.synchronize()
    print(f"phase 7: K3 == plain on {cases} cases (max_abs_err {worst})")
    return cases, worst


def failure_epoch(osdmap):
    """100 OSDs out, 100 others reweighted to 0x8000, 50 others down."""
    from ceph_tpu_torch.osd.osdmap import Incremental
    order = np.random.default_rng(SEED).permutation(N_OSD)
    out, part, down = order[:100], order[100:200], order[200:250]
    inc = Incremental(epoch=osdmap.epoch + 1)
    inc.new_weight.update({int(o): 0 for o in out})
    inc.new_weight.update({int(o): 0x8000 for o in part})
    inc.new_down_osds.extend(int(o) for o in down)
    return inc, out, down


def drive_placement(om, placement) -> dict:
    """Phase 8: OSDMapMapping.update on the card, before and after the
    failure epoch, each checked against the scalar pipeline."""
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
    from ceph_tpu_torch.osd.types import PG
    rng = np.random.default_rng(SEED + 1)
    mapping = om.OSDMapMapping()            # device None: the card
    times = []
    for epoch in (1, 2):
        if epoch == 2:
            inc, out, down = failure_epoch(placement)
            placement.apply_incremental(inc)
        t0 = time.monotonic()
        mapping.update(placement)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        for pool_id, pool in placement.pools.items():
            pm = mapping.pools[pool_id]
            if pm.up.shape != (pool.pg_num, pool.size):
                raise AssertionError(f"pool {pool_id}: up {pm.up.shape}")
            vals = pm.up[pm.up != CRUSH_ITEM_NONE]
            if vals.size == 0 or vals.min() < 0 or vals.max() >= N_OSD:
                raise AssertionError(f"pool {pool_id}: OSD ids out of range")
            for ps in rng.choice(pool.pg_num, SAMPLE, replace=False):
                pg = PG(pool_id, int(ps))
                if mapping.get(pg) != placement.pg_to_up_acting_osds(pg):
                    raise AssertionError(f"epoch {epoch}: {pg} differs from "
                                         "the scalar pipeline")
        counts = mapping.osd_pg_counts(N_OSD)
        if epoch == 1 and counts.min() == 0:
            raise AssertionError("an OSD carries no PG on the all-in map")
        if epoch == 2 and (counts[out].any() or counts[down].any()):
            raise AssertionError("an out or down OSD still carries PGs")
        holes = int((mapping.pools[1].up == CRUSH_ITEM_NONE).sum())
        print(f"phase 8: epoch {epoch}: update() {times[-1]:.3f} s on the "
              f"host clock; {SAMPLE} sampled PGs of each pool == scalar "
              f"pg_to_up_acting_osds; PGs per OSD (acting, both pools) min "
              f"{int(counts.min())} max {int(counts.max())} mean "
              f"{float(counts.mean()):.2f}; EC holes {holes}")
    return {"mapping": mapping, "update_s": times}


def update_split(cb, om, placement, dev) -> dict:
    """Host-clock split of one OSDMapMapping.update() of the current map:
    the pieces timed one by one with the calls update() makes (table
    staging by compile_map; per pool, the seed hashing and map_batch with
    the copy back); the rest of update() is the numpy epilogue (filters,
    compaction, primary affinity, temp rows)."""
    weights = np.asarray(placement.osd_weight, dtype=np.int64)
    t0 = time.monotonic()
    om.OSDMapMapping().update(placement)
    torch.cuda.synchronize()
    split = {"update": time.monotonic() - t0, "pps": 0.0, "map_batch": 0.0}
    t0 = time.monotonic()
    cc = cb.compile_map(placement.crush, device=dev)
    split["compile_map"] = time.monotonic() - t0
    for pool_id, pool in placement.pools.items():
        t0 = time.monotonic()
        pps = pool.raw_pg_to_pps_batch(np.arange(pool.pg_num), pool_id)
        t1 = time.monotonic()
        res, cnt = cc.map_batch(pps, weights, ruleno=placement.crush.find_rule(
            pool.crush_rule, pool.type, pool.size), result_max=pool.size,
            return_counts=True)
        res.cpu().numpy(), cnt.cpu().numpy()
        split["pps"] += t1 - t0
        split["map_batch"] += time.monotonic() - t1
    split["epilogue"] = split["update"] - split["compile_map"] - \
        split["pps"] - split["map_batch"]
    return split


def crush_phases(log: str, name_power: str, dev) -> tuple[dict, object]:
    """Phases 7-9; returns K3's entry of the kernels line and the
    placement map (at its failure epoch)."""
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.crush import testing as ct
    from ceph_tpu_torch.ec.kernels import _build
    from ceph_tpu_torch.osd import mapping as om

    ptx = ptxas_report(log, "crush_do_rule_kernel")
    print(f"phase 7: K3 ptxas: {ptx['registers']} registers, "
          f"{ptx['stack_frame_bytes']} bytes stack frame, "
          f"{ptx['spill_store_bytes']} bytes spill stores, "
          f"{ptx['spill_load_bytes']} bytes spill loads")
    placement = placement_map()
    w_all_in = np.asarray(placement.osd_weight, dtype=np.int64)
    cases, err = check_k3(cb, ct, placement, dev)

    cb.reset_launches()
    om.reset_fallbacks()
    state = drive_placement(om, placement)
    launches = cb.LAUNCHES["crush_do_rule"]
    fallbacks = om.FALLBACKS["batch_unsupported"]
    print(f"phase 8: launches crush_do_rule {launches}, pools through the "
          f"scalar engine {fallbacks}")
    if launches == 0 or fallbacks:
        raise AssertionError("the placement path did not run through K3")

    # -- phase 9: timing and the bound ----------------------------------
    pool = placement.pools[0]
    ruleno = placement.crush.find_rule(pool.crush_rule, pool.type, pool.size)
    cc = cb.compile_map(placement.crush, device=dev)
    cfg = cc.rule_cfg(ruleno, pool.size)
    pps = torch.from_numpy(pool.raw_pg_to_pps_batch(
        np.arange(PG_NUM), 0)).to(dev)
    weight = torch.from_numpy(w_all_in).to(dev)
    with ClockSampler() as clock:
        k3_ms = time_ms(lambda: cb.crush_do_rule_cuda(cc, cfg, pps, weight),
                        reps=3, repeats=5)
    k3_part_ms = time_ms(lambda: cb.crush_do_rule_cuda(
        cc, cfg, pps[:PLAIN_SEEDS], weight), reps=3, repeats=5)
    plain_ms = time_ms(lambda: cb.map_batch_plain(
        cc, cfg, pps[:PLAIN_SEEDS], weight), reps=1, repeats=3)
    ec = placement.pools[1]
    ec_cfg = cc.rule_cfg(placement.crush.find_rule(
        ec.crush_rule, ec.type, ec.size), ec.size)
    ec_pps = torch.from_numpy(ec.raw_pg_to_pps_batch(
        np.arange(EC_PG_NUM), 1)).to(dev)
    k3_ec_ms = time_ms(lambda: cb.crush_do_rule_cuda(cc, ec_cfg, ec_pps,
                                                     weight), reps=3,
                       repeats=5)
    # the work of this run's seeds, counted by the plain version, which
    # also holds K3 to it over all 1,048,576 seeds
    stats = {}
    want, want_n = cb.map_batch_plain(cc, cfg, pps, weight, stats=stats)
    got, got_n = cb.crush_do_rule_cuda(cc, cfg, pps, weight)
    err = max(err, max_err32(got, want), max_err32(got_n, want_n))
    if err:
        raise AssertionError("K3 differs from plain over the 1M seeds")
    lib = _build.lib_path("crush_rule")
    hash_instr = sass_instructions(lib, "crush_jhash3_probe") - \
        sass_instructions(lib, "crush_xor3_probe")
    mhz = max(clock.mhz) if clock.mhz else int(subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], check=True, capture_output=True,
        text=True, timeout=60).stdout.split()[0])
    evals = stats["straw2_evals"]
    ops_ms = evals * hash_instr / (SMS * INT32_LANES * mhz * 1e6) * 1e3
    table_bytes = sum(t.numel() * t.element_size() for t in (
        cc.items, cc.ids, cc.weights, cc.sizes, cc.btypes, cc.valid)) + \
        65536 * 8 + weight.numel() * 8
    nbytes = PG_NUM * (8 + 4 * pool.size + 4) + table_bytes
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (ops_ms, "operations") if ops_ms >= bytes_ms \
        else (bytes_ms, "bytes")
    update_s = state["update_s"]
    split = update_split(cb, om, placement, dev)
    print("phase 9: update() split on the host clock (failure-epoch map): "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))
    print(f"phase 9: K3 {k3_ms:.4f} ms per {PG_NUM} seeds "
          f"({PG_NUM / k3_ms * 1e3:.1f} mappings/s), {k3_part_ms:.4f} ms per "
          f"{PLAIN_SEEDS}; plain {plain_ms:.4f} ms per {PLAIN_SEEDS}; "
          f"update() of both pools {update_s[0]:.3f} s then "
          f"{update_s[1]:.3f} s on the host clock "
          f"({(PG_NUM + EC_PG_NUM) / update_s[0]:.1f} and "
          f"{(PG_NUM + EC_PG_NUM) / update_s[1]:.1f} mappings/s); K3 on "
          f"the EC pool's {EC_PG_NUM} seeds {k3_ec_ms:.4f} ms, so K3 is "
          f"{(k3_ms + k3_ec_ms) / 1e3 / update_s[0]:.3f} of the first "
          f"update() on {name_power}")
    print(f"phase 9: K3 bound {bound_ms:.4f} ms by {bound_by}: {evals} "
          f"straw2 item evaluations ({evals / PG_NUM:.2f} per seed) x "
          f"{hash_instr} SASS instructions per hash / ({SMS} SMs x "
          f"{INT32_LANES} INT32 lanes x {mhz} MHz, SM clock read "
          f"{min(clock.mhz or [0])}-{max(clock.mhz or [0])} MHz); bytes "
          f"{nbytes} -> {bytes_ms:.4f} ms")
    return {"name": "crush_do_rule", "route": "cuda",
            "source": "ceph_tpu_torch/crush/kernels/csrc/crush_rule.cu",
            "replaces": "ceph_tpu/crush/batch.py:885",
            "launches": launches, "max_abs_err": err, "ms": k3_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "seeds": PG_NUM, "plain_seeds": PLAIN_SEEDS,
            "ms_at_plain_seeds": k3_part_ms, "ec_pool_ms": k3_ec_ms,
            "cases": cases,
            "straw2_evals": evals, "hash_sass_instructions": hash_instr,
            "sm_clock_mhz": mhz, "bytes": nbytes, "bytes_ms": bytes_ms,
            "update_s": update_s, "update_split_s": split, **ptx}, placement


# ---------------------------------------------------------------------------
# Compiled repair: phases 10-11

def helper_bufs(ecutil, plan, shards: dict, cs: int) -> dict:
    """Each helper's shard stream cut to the plan's extents, stripe by
    stripe: exactly the bytes an OSD ships for the repair."""
    ext = plan.byte_extents(cs)
    return {h: b"".join(shards[h][o:o + c] for o, c in
                        ecutil.expand_stream_extents(ext[h], cs,
                                                     len(shards[h])))
            for h in plan.helper_ids()}


def encode_objects(ecutil, ec, sinfo, count: int, seed: int) -> list[dict]:
    """`count` objects of REPAIR_OBJECT bytes (the last stripe padded
    with zeros), made from the seed and encoded by ecutil on the host."""
    rng = np.random.default_rng(seed)
    size = -(-REPAIR_OBJECT // sinfo.stripe_width) * sinfo.stripe_width
    out = []
    for _ in range(count):
        data = rng.integers(0, 256, REPAIR_OBJECT, dtype=np.uint8).tobytes()
        out.append(ecutil.encode(sinfo, ec, data + bytes(size - len(data))))
    return out


def drive_repair(registry, ecutil, repairc, plugin: str, profile: dict,
                 ratio: float, calls: list) -> dict:
    """Phase 10 for one code on the card: lose shard 0 of REPAIR_OBJECTS
    objects and rebuild it twice through compiled_repair_streams; check
    every signature on object 0, the byte ratio and one compile per
    signature.  Appends one entry to `calls` per compiled repair (one K1
    launch each)."""
    ec = registry.factory(plugin, dict(profile))     # device None: the card
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    cs = ec.get_chunk_size(k * STRIPE_UNIT)
    sinfo = ecutil.StripeInfo(k, k * cs)
    t0 = time.monotonic()
    objs = encode_objects(ecutil, ec, sinfo, REPAIR_OBJECTS, SEED)
    t_encode = time.monotonic() - t0
    plan = ecutil.repair_plan(ec, {0}, set(range(n)) - {0})
    bufs = [helper_bufs(ecutil, plan, s, cs) for s in objs]
    read = sum(len(b) for b in bufs[0].values())
    rebuilt = len(objs[0][0])
    if read / rebuilt != ratio or \
            plan.total_planes() / plan.output_planes() != ratio:
        raise AssertionError(f"{plugin}: read/rebuilt {read}/{rebuilt}, "
                             f"want {ratio}")
    passes = []
    for _ in range(2):                # the first pass compiles the plan
        t0 = time.monotonic()
        outs = [ecutil.compiled_repair_streams(ec, plan, cs, b) for b in bufs]
        passes.append(time.monotonic() - t0)
        calls.extend([plugin] * len(bufs))
        if any(o[0] != s[0] for o, s in zip(outs, objs)):
            raise AssertionError(f"{plugin}: a rebuilt shard 0 differs")
    extra = {}
    if plugin == "jerasure":
        plan2 = ecutil.repair_plan(ec, {1, 2}, set(range(n)) - {1, 2})
        for s in objs:
            out = ecutil.compiled_repair_streams(
                ec, plan2, cs, helper_bufs(ecutil, plan2, s, cs))
            calls.append(plugin)
            if out[1] != s[1] or out[2] != s[2]:
                raise AssertionError("jerasure: lost {1, 2} differs")
        extra = {"plan2": plan2, "bufs2": helper_bufs(ecutil, plan2,
                                                       objs[0], cs)}
    sigs = [{s} for s in range(n)]
    if plugin == "jerasure":
        sigs += [set(p) for p in itertools.combinations(range(n), 2)]
    for lost in sigs:
        p = ecutil.repair_plan(ec, lost, set(range(n)) - lost)
        out = ecutil.compiled_repair_streams(
            ec, p, cs, helper_bufs(ecutil, p, objs[0], cs))
        calls.append(plugin)
        if any(out[s] != objs[0][s] for s in lost):
            raise AssertionError(f"{plugin}: signature {sorted(lost)} differs")
    compiles = repairc.cache_of(ec).stats()["compiles"]
    if len(compiles) != len(sigs) or set(compiles.values()) != {1}:
        raise AssertionError(f"{plugin}: compiles {compiles}")
    print(f"phase 10: {plugin} {profile}: {REPAIR_OBJECTS} x {REPAIR_OBJECT} "
          f"B objects, chunk {cs} B, {len(objs[0][0]) // cs} stripes; "
          f"ecutil.encode {t_encode:.1f} s on the host; shard 0 rebuilt "
          f"twice == original; read/rebuilt {read}/{rebuilt} = "
          f"{read / rebuilt}; {len(sigs)} signatures on object 0 == "
          f"original, one compile each; compiled repair of all objects "
          f"{passes[0]:.3f} s (first pass, compiles) then {passes[1]:.3f} s")
    return {"plugin": plugin, "ec": ec, "plan": plan, "bufs": bufs,
            "want": [s[0] for s in objs], "cs": cs, "passes": passes,
            "encode_s": t_encode, "rebuilt": rebuilt, "read": read, **extra}


def rebuild_pass(ecutil, state: dict) -> float:
    """Host-clock seconds of one compiled_repair_streams over every
    object, each output dropped at once (as an OSD that writes the
    rebuilt shard out and moves on)."""
    ec, plan, cs = state["ec"], state["plan"], state["cs"]
    t0 = time.monotonic()
    for bufs in state["bufs"]:
        ecutil.compiled_repair_streams(ec, plan, cs, bufs)
    return time.monotonic() - t0


def repair_split(ecutil, state: dict) -> dict:
    """Phase 11 for one code: a rebuild of every object timed piece by
    piece with the calls RepairProgram.run makes (gather, copy in, K1,
    copy back, scatter; K1 also by CUDA events around its launch, the
    host's launch cost included), between two whole passes of
    compiled_repair_streams; then the top functions of a third pass by
    cProfile's own time."""
    import cProfile
    import pstats
    from ceph_tpu_torch import device as _device
    from ceph_tpu_torch.ec.repairc import program_for
    ec, plan, cs = state["ec"], state["plan"], state["cs"]
    prog = program_for(ec, plan)
    mm = prog.kernel(ec.device)
    whole = [rebuild_pass(ecutil, state)]
    split = dict.fromkeys(("gather", "h2d", "k1", "d2h", "scatter"), 0.0)
    k1_events = 0.0
    for bufs, want in zip(state["bufs"], state["want"]):
        t0 = time.monotonic()
        x, nstripes, ssz = prog._gather(bufs, cs)
        t1 = time.monotonic()
        x_dev = _device.as_u8(x, ec.device)
        torch.cuda.synchronize()
        t2 = time.monotonic()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out_dev = mm(x_dev)
        end.record()
        end.synchronize()
        t3 = time.monotonic()
        out = out_dev.cpu().numpy()
        t4 = time.monotonic()
        streams = prog._scatter(out, nstripes, ssz)
        t5 = time.monotonic()
        if streams[0] != want:
            raise AssertionError(f"{state['plugin']}: split rebuild differs")
        for key, a, b in (("gather", t0, t1), ("h2d", t1, t2), ("k1", t2, t3),
                          ("d2h", t3, t4), ("scatter", t4, t5)):
            split[key] += b - a
        k1_events += start.elapsed_time(end)
    whole.append(rebuild_pass(ecutil, state))
    prof = cProfile.Profile()
    prof.runcall(rebuild_pass, ecutil, state)
    stats = pstats.Stats(prof).stats
    top = sorted(((v[2], f"{Path(k[0]).name}:{k[1]}({k[2]})")
                  for k, v in stats.items()), reverse=True)[:6]
    total = sum(split.values())
    rebuilt = state["rebuilt"] * len(state["bufs"])
    return {"split_s": split, "total_s": total, "k1_events_ms": k1_events,
            "rebuilt_MBps": rebuilt / total / 1e6,
            "pass_MBps": [rebuilt / t / 1e6 for t in state["passes"]],
            "dropped_pass_s": whole,
            "dropped_pass_MBps": [rebuilt / t / 1e6 for t in whole],
            "profile_top_s": [[name, t] for t, name in top]}


def repair_phases(name_power: str, gen: torch.Generator,
                  dev) -> tuple[dict, dict]:
    """Phases 10-11; returns the keys K1's entry of the kernels line
    gains and the first code's phase-10 state."""
    from ceph_tpu_torch.ec import bitmatrix, registry, repairc
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import ecutil

    calls: list = []
    bm.reset_launches()
    states = [drive_repair(registry, ecutil, repairc, plugin, profile, ratio,
                           calls) for plugin, profile, ratio in REPAIR_CODES]
    # the corpus's wider clay profile: one object, 27 x 72 repair matrix
    wide = registry.factory("clay", dict(WIDE_CLAY))
    k = wide.get_data_chunk_count()
    cs = wide.get_chunk_size(k * STRIPE_UNIT)
    shards = encode_objects(ecutil, wide, ecutil.StripeInfo(k, k * cs), 1,
                            SEED)[0]
    wide_plan = ecutil.repair_plan(wide, {0},
                                   set(range(1, wide.get_chunk_count())))
    wide_bufs = helper_bufs(ecutil, wide_plan, shards, cs)
    if ecutil.compiled_repair_streams(wide, wide_plan, cs,
                                      wide_bufs)[0] != shards[0]:
        raise AssertionError("clay k=6 m=3 d=8: rebuilt shard 0 differs")
    calls.append("clay k6m3d8")
    # the bit-matrix device form over one object of packets
    bit_codes = {"liber8tion k=8": bitmatrix.liber8tion_bitmatrix(8),
                 "liberation k=7 w=7": bitmatrix.liberation_bitmatrix(7, 7),
                 "blaum_roth k=6 w=6": bitmatrix.blaum_roth_bitmatrix(6, 6)}
    rng = np.random.default_rng(SEED)
    bit_inputs = {}
    for label, g in bit_codes.items():
        rows = g.shape[1]
        packets = rng.integers(0, 256, (rows, REPAIR_OBJECT // rows),
                               dtype=np.uint8)
        got = bitmatrix.gf2_matmul_device(g[rows:], packets)
        calls.append(label)
        if not np.array_equal(got.cpu().numpy(),
                              bitmatrix.bitmatrix_apply(g[rows:], packets)):
            raise AssertionError(f"gf2_matmul_device differs: {label}")
        bit_inputs[label] = (g[rows:], packets)
    launches = bm.LAUNCHES["gf_matmul"]
    print(f"phase 10: launches gf_matmul {launches} for {len(calls)} "
          f"compiled repairs and bit-matrix products (one each); clay k=6 "
          f"m=3 d=8 shard 0 == original; gf2_matmul_device == "
          f"bitmatrix_apply for {', '.join(bit_codes)}")
    if launches == 0 or launches != len(calls) or \
            bm.LAUNCHES["gf_decode_select"]:
        raise AssertionError("the repair path did not run through K1 once "
                             "per repair")

    # -- K1 at each repair shape against its plain version, then timed --
    def bound(r: int, k_in: int, n: int) -> tuple[float, str]:
        tb = (k_in + r) * n / HBM_BYTES_PER_S * 1e3
        to = r * k_in * n / INT8_OPS_PER_S * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    shapes = []
    for st in states:
        shapes.append((f"{st['plugin']} lost 0", st["ec"], st["plan"],
                       st["bufs"][0], st["cs"]))
        if "plan2" in st:
            shapes.append((f"{st['plugin']} lost 1,2", st["ec"], st["plan2"],
                           st["bufs2"], st["cs"]))
    shapes.append(("clay k6m3d8 lost 0", wide, wide_plan, wide_bufs, cs))
    cases = []
    for label, ec, plan, bufs, c in shapes:
        prog = repairc.program_for(ec, plan)
        x = torch.from_numpy(prog._gather(bufs, c)[0]).to(dev)[None]
        cases.append((label, prog.matrix, x))
    for label, (mat, packets) in bit_inputs.items():
        cases.append((label, mat, torch.from_numpy(packets).to(dev)[None]))
    for r, k_in, n in ((16, 256, 65536), (4, 400, 65536)):
        cases.append((f"random {r}x{k_in}",
                      torch.randint(0, 256, (r, k_in), generator=gen,
                                    device=dev, dtype=torch.uint8)
                      .cpu().numpy(),
                      torch.randint(0, 256, (1, k_in, n), generator=gen,
                                    device=dev, dtype=torch.uint8)))
    worst = 0
    rows = []
    for label, mat, x in cases:
        r, (_, k_in, n) = mat.shape[0], x.shape
        tables = torch.from_numpy(bm.packed_nibble_tables(mat)).to(dev)
        mat_t = torch.from_numpy(np.ascontiguousarray(mat)).to(dev)
        err = max_err(bm.gf_matmul_cuda(tables, x, r),
                      bm.gf_matmul_plain(mat_t, x))
        torch.cuda.synchronize()
        if err:
            raise AssertionError(f"K1 differs from plain at {label}")
        worst = max(worst, err)
        b_ms, b_by = bound(r, k_in, n)
        rows.append({"shape": label, "r": r, "k_in": k_in, "n": n,
                     "ms": device_ms(lambda: bm.gf_matmul_cuda(tables, x, r)),
                     "paced_ms": time_ms(
                         lambda: bm.gf_matmul_cuda(tables, x, r)),
                     "plain_ms": time_ms(lambda: bm.gf_matmul_plain(mat_t, x),
                                         reps=1, repeats=3),
                     "bound_ms": b_ms, "bound_by": b_by})
    print(f"phase 10: K1 == plain at {len(cases)} repair shapes, "
          f"max_abs_err {worst}")

    # -- phase 11: the rebuild split and K1 per launch ---------------------
    splits = {}
    for st in states:
        sp = repair_split(ecutil, st)
        splits[st["plugin"]] = sp
        s = sp["split_s"]
        print(f"phase 11: {st['plugin']} rebuild of {REPAIR_OBJECTS} "
              f"objects, split: {sp['rebuilt_MBps']:.1f} MB/s rebuilt on "
              f"the host clock ({sp['total_s']:.3f} s: gather "
              f"{s['gather']:.3f}, copy in {s['h2d']:.3f}, K1 {s['k1']:.3f} "
              f"(CUDA events {sp['k1_events_ms'] / 1e3:.4f}), copy back "
              f"{s['d2h']:.3f}, scatter {s['scatter']:.3f} s); "
              f"compiled_repair_streams {sp['pass_MBps'][0]:.1f} MB/s first "
              f"pass (compiles), {sp['pass_MBps'][1]:.1f} MB/s second "
              f"(outputs kept), {sp['dropped_pass_MBps'][0]:.1f} and "
              f"{sp['dropped_pass_MBps'][1]:.1f} MB/s before and after the "
              f"split (outputs dropped); on {name_power}")
        print(f"phase 11: {st['plugin']} pass by cProfile own time: "
              + ", ".join(f"{name} {t:.3f} s"
                          for name, t in sp["profile_top_s"]))
    for row in rows:
        print(f"phase 11: K1 {row['shape']} ({row['r']} x {row['k_in']}, N "
              f"{row['n']}): {row['ms']:.4f} ms on the card "
              f"({row['paced_ms']:.4f} ms launched one after another from "
              f"the host), bound {row['bound_ms']:.4f} ms by "
              f"{row['bound_by']} ({row['bound_ms'] / row['ms']:.2f} of "
              f"it), plain {row['plain_ms']:.4f} ms on {name_power}")
    return {"launches_repair": launches, "max_abs_err_repair": worst,
            "repair_shapes": rows,
            "repair": {p: {"encode_s": st["encode_s"],
                           "passes_s": st["passes"], **splits[p]}
                       for p, st in zip(splits, states)}}, states[0]


# ---------------------------------------------------------------------------
# The placement tools: phases 12-13; the device guard: phase 14

def run_cli(tool_main, argv: list[str]) -> tuple[str, str, float]:
    """One run of a tool's main(argv): (stdout, stderr, host seconds up
    to a synchronize).  A non-zero exit fails the run."""
    out, err = io.StringIO(), io.StringIO()
    t0 = time.monotonic()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = tool_main(argv)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    if rc != 0:
        raise AssertionError(f"{argv}: exit {rc}: {err.getvalue()[-2000:]}")
    return out.getvalue(), err.getvalue(), wall


def edited_crushmap(text: str) -> str:
    """The decompiled --build map with the two rules a user appends
    (Ceph's "Editing a CRUSH map": decompile, edit, compile)."""
    if "# rules\n" not in text:
        raise AssertionError("decompiled map has no rules section")
    return text.replace("# rules\n", "# rules\n" + TOOL_RULES)


@contextlib.contextmanager
def k3_events(cb):
    """Within the block, every K3 launch that map_batch makes is bracketed
    by CUDA events; yields the list of (start, end) pairs.  The launch
    itself, and its count, are the wrapper's."""
    pairs = []
    launch = cb.crush_do_rule_cuda

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    cb.crush_do_rule_cuda = timed
    try:
        yield pairs
    finally:
        cb.crush_do_rule_cuda = launch


def events_ms(pairs) -> float:
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs)


def crushtool_phase(name_power: str, dev, work: Path) -> dict:
    """Phase 12: crushtool --build / -d / edit / -c / --test on the card."""
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.crush import tester as ctest
    from ceph_tpu_torch.crush.compiler import compile_crushmap, decompile
    from ceph_tpu_torch.tools import crushtool

    t_phase = time.monotonic()
    built, text, edited, mapfile = (str(work / n) for n in (
        "built.json", "built.txt", "edited.txt", "map.json"))
    run_cli(crushtool.main, ["--build", "--num-osds", str(N_OSD), "-o", built,
                             "host", "straw2", str(OSDS_PER_HOST),
                             "root", "straw2", "0"])
    run_cli(crushtool.main, ["-d", built, "-o", text])
    Path(edited).write_text(edited_crushmap(Path(text).read_text()))
    run_cli(crushtool.main, ["-c", edited, "-o", mapfile])
    w = crushtool.load(mapfile)
    t2 = decompile(w)
    if t2 != Path(edited).read_text() or decompile(compile_crushmap(t2)) != t2:
        raise AssertionError("crushtool -c / -d is not a fixed point")
    hosts = sum(1 for b in w.crush.buckets
                if b is not None and w.type_map[b.type] == "host")
    if w.crush.max_devices != N_OSD or hosts != N_OSD // OSDS_PER_HOST:
        raise AssertionError(f"--build gave {w.crush.max_devices} OSDs, "
                             f"{hosts} hosts")

    def test_argv(rule: int, nr: int, max_x: int) -> list[str]:
        return ["-i", mapfile, "--test", "--show-statistics",
                "--show-utilization", "--min-x", "0", "--max-x", str(max_x),
                "--rule", str(rule), "--num-rep", str(nr)]

    cb.reset_launches()
    ctest.reset_fallbacks()
    outs, walls, k3_cli = {}, {}, {}
    for rule, nr in TOOL_TESTS:
        with k3_events(cb) as pairs:
            outs[rule], _, walls[rule] = run_cli(
                crushtool.main, test_argv(rule, nr, TOOL_X - 1))
        k3_cli[rule] = events_ms(pairs)
    launches = cb.LAUNCHES["crush_do_rule"]
    fallbacks = ctest.FALLBACKS["batch_unsupported"]
    if launches != len(TOOL_TESTS) or fallbacks:
        raise AssertionError(f"crushtool --test: {launches} K3 launches for "
                             f"{len(TOOL_TESTS)} (rule, num_rep), "
                             f"{fallbacks} through the scalar engine")

    class TablesTester(ctest.CrushTester):
        """The tester's counting and text over tables it is given."""

        def __init__(self, tables, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.tables = tables

        def map_all(self, ruleno, numrep, timings=None):
            return self.tables

    flags = {"show_statistics": True, "show_utilization": True}
    cc = cb.compile_map(w.crush, device=dev)
    xs = torch.arange(TOOL_X, device=dev)
    weight = torch.full((N_OSD,), 0x10000, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(SEED + 2)
    rows, worst = {}, 0
    for rule, nr in TOOL_TESTS:
        name = w.rule_name_map[rule]
        if f"rule {rule} ({name}) num_rep {nr} result size == {nr}:\t" \
                f"{TOOL_X}/{TOOL_X}" not in outs[rule]:
            raise AssertionError(f"rule {rule}: not every x maps to {nr}")
        # K3 against the plain version on the card, over every
        # TOOL_PLAIN_STRIDE[rule]-th x of the whole range
        cfg = cc.rule_cfg(rule, nr)
        got, got_n = cb.crush_do_rule_cuda(cc, cfg, xs, weight)
        stride = TOOL_PLAIN_STRIDE[rule]
        n_plain = TOOL_X // stride
        torch.cuda.synchronize()
        t_plain = time.monotonic()
        want, want_n = cb.map_batch_plain(cc, cfg, xs[::stride].contiguous(),
                                          weight, chunk=TOOL_PLAIN_CHUNK)
        torch.cuda.synchronize()
        t_plain = time.monotonic() - t_plain
        err = max(max_err32(got[::stride], want),
                  max_err32(got_n[::stride], want_n))
        worst = max(worst, err)
        if err:
            raise AssertionError(f"rule {rule}: K3 differs from the plain "
                                 f"version over every {stride}th x")
        res, cnt = got.cpu().numpy(), got_n.cpu().numpy()
        if stride == 1:
            # the tool's whole text against the plain version's tables
            plain = TablesTester((want.cpu().numpy(), want_n.cpu().numpy()),
                                 w, 0, TOOL_X - 1, nr, nr, rule, device=dev)
            if plain.test(**flags) != outs[rule]:
                raise AssertionError(f"rule {rule}: crushtool --test text "
                                     "differs from the plain version's")
            held = (f"K3 == plain version on every x (max_abs_err {err}, "
                    f"plain {t_plain:.1f} s) and the text == the plain "
                    "version's")
        else:
            held = (f"K3 == plain version on every {stride}th x, {n_plain} "
                    f"x over 0..{TOOL_X - 1} (max_abs_err {err}, plain "
                    f"{t_plain:.1f} s; cut from {TOOL_X} x to keep the "
                    "smoke's wall time, so no text check against the plain "
                    "version for this rule)")
        t_sample = time.monotonic()
        for x in rng.choice(TOOL_X, TOOL_SAMPLE, replace=False).tolist():
            if res[x, :cnt[x]].tolist() != w.do_rule(rule, x, nr):
                raise AssertionError(f"rule {rule} x {x}: K3 differs from "
                                     "CrushWrapper.do_rule")
        t_sample = time.monotonic() - t_sample
        # the host-clock split, every piece a lap of this one run: the
        # tool's map load, then CrushTester.test with its timings; K3 by
        # CUDA events in the same run
        timings = {}
        with k3_events(cb) as pairs:
            t0 = time.monotonic()
            w_run = crushtool.load(mapfile)
            t_load = time.monotonic() - t0
            text_run = ctest.CrushTester(w_run, 0, TOOL_X - 1, nr, nr, rule,
                                         device=dev).test(**flags,
                                                          timings=timings)
            wall_run = time.monotonic() - t0
        if text_run != outs[rule]:
            raise AssertionError(f"rule {rule}: CrushTester.test differs "
                                 "from the tool's text")
        split = {"load": t_load, **timings}
        k3_ms = events_ms(pairs)
        devices = outs[rule].count("  device ")
        rows[rule] = {"num_rep": nr, "wall_s": walls[rule],
                      "k3_events_ms": k3_cli[rule], "split_wall_s": wall_run,
                      "split_s": split, "split_k3_events_ms": k3_ms,
                      "plain_s": t_plain, "plain_x": n_plain,
                      "plain_stride": stride,
                      "devices_listed": devices}
        print(f"phase 12: crushtool --test rule {rule} ({name}) num_rep {nr} "
              f"x 0..{TOOL_X - 1}: {walls[rule]:.3f} s on the host clock, K3 "
              f"{k3_cli[rule]:.3f} ms by CUDA events in that run "
              f"({k3_cli[rule] / 1e3 / walls[rule]:.4f} of it); {devices} "
              f"devices listed; {held}; {TOOL_SAMPLE} sampled x == "
              f"CrushWrapper.do_rule ({t_sample:.1f} s) on {name_power}")
        print(f"phase 12: split of one more run, each piece a lap of it: "
              f"{wall_run:.3f} s = "
              + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
              + f", the rest {wall_run - sum(split.values()):.3f} s; K3 "
              f"{k3_ms:.3f} ms by CUDA events")

    # the text against CrushTester on the CPU, at a range the CPU's plain
    # version takes seconds for
    t_cpu = time.monotonic()
    for rule, nr in TOOL_TESTS:
        card_text, _, _ = run_cli(crushtool.main,
                                  test_argv(rule, nr, TOOL_CPU_X - 1))
        if card_text != ctest.CrushTester(w, 0, TOOL_CPU_X - 1, nr, nr, rule,
                                          device="cpu").test(**flags):
            raise AssertionError(f"rule {rule} at {TOOL_CPU_X} x: the text "
                                 "differs from CrushTester on the CPU")
    t_cpu = time.monotonic() - t_cpu
    wall = time.monotonic() - t_phase
    print(f"phase 12: crushtool --build {N_OSD} / -d / -c fixed point; "
          f"--test text == CrushTester(device=\"cpu\")'s at {TOOL_CPU_X} x "
          f"for both rules ({t_cpu:.1f} s); K3 launches {launches}, tester "
          f"fallbacks {fallbacks}; phase {wall:.1f} s")
    return {"launches": launches, "rows": rows, "wall_s": wall,
            "max_abs_err": worst, "mapfile": mapfile}


def parse_upmaps(text: str):
    """`ceph osd pg-upmap-items` lines -> {PG: [(from, to), ...]}; any
    other line fails the run."""
    from ceph_tpu_torch.osd.types import PG
    items = {}
    for line in text.splitlines():
        head = "ceph osd pg-upmap-items "
        if not line.startswith(head):
            raise AssertionError(f"unexpected upmap line {line!r}")
        pgid, *nums = line[len(head):].split()
        pool, ps = pgid.split(".")
        pairs = [int(v) for v in nums]
        items[PG(int(pool), int(ps, 16))] = list(zip(pairs[::2], pairs[1::2]))
    return items


def balancer_phase(name_power: str, dev, work: Path) -> dict:
    """Phase 13: osdmaptool --createsimple / --upmap --test-map-pgs on
    the card at full scale, the split, and card against CPU at 1,000
    OSDs."""
    import random

    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.crush import remap
    from ceph_tpu_torch.osd import balancer as bal
    from ceph_tpu_torch.osd import mapping as om
    from ceph_tpu_torch.osd.osdmap import Incremental
    from ceph_tpu_torch.tools import osdmaptool

    t_phase = time.monotonic()
    mapfile, upfile = str(work / "om.json"), str(work / "upmap.txt")
    run_cli(osdmaptool.main, ["--createsimple", str(N_OSD), "--osds-per-host",
                              str(OSDS_PER_HOST), "--pg-num", str(PG_NUM),
                              mapfile])
    cb.reset_launches()
    om.reset_fallbacks()
    with k3_events(cb) as pairs:
        stats_text, err, wall = run_cli(osdmaptool.main, [
            mapfile, "--upmap", upfile, "--upmap-max", str(UPMAP_MAX),
            "--upmap-deviation", str(UPMAP_DEVIATION), "--test-map-pgs"])
    k3_ms = events_ms(pairs)
    launches = cb.LAUNCHES["crush_do_rule"]
    if launches != 2 or om.FALLBACKS["batch_unsupported"]:
        raise AssertionError(f"--upmap --test-map-pgs: {launches} K3 "
                             "launches (want the balancer's update() and "
                             "--test-map-pgs's), scalar-engine pools "
                             f"{om.FALLBACKS['batch_unsupported']}")
    prepared = re.search(r"prepared (\d+)/(\d+) changes", err)
    items = parse_upmaps(Path(upfile).read_text())
    if not prepared or int(prepared.group(1)) != len(items) or not items:
        raise AssertionError(f"balancer output: {err!r}")
    if f"pool 0 pg_num {PG_NUM}" not in stats_text or \
            f" in {N_OSD}" not in stats_text or \
            f"size 3\t{PG_NUM}" not in stats_text:
        raise AssertionError("--test-map-pgs stats are incomplete")

    # the invariants of the balanced map, on the card and the scalar path
    m = osdmaptool.load_map(mapfile)
    inc = Incremental(epoch=m.epoch + 1)
    inc.new_pg_upmap_items.update(items)
    after = m.clone()
    after.apply_incremental(inc)
    mapping = om.OSDMapMapping()
    mapping.update(after)
    parent = remap.build_parent_map(after.crush)
    for pg, pairs in items.items():
        up = mapping.get(pg)
        if up != after.pg_to_up_acting_osds(pg):
            raise AssertionError(f"{pg}: card mapping differs from scalar")
        hosts = {remap.get_parent_of_type(after.crush, o, 1, parent)
                 for o in up[0]}
        if len(up[0]) != 3 or len(hosts) != 3 or \
                any(to not in up[0] for _, to in pairs):
            raise AssertionError(f"{pg}: up {up[0]} after the upmap")
    b = bal.Balancer(max_deviation=UPMAP_DEVIATION,
                     max_iterations=UPMAP_MAX)
    before_score, after_score = b.score(m), b.score(after)
    if not after_score["stddev"] < before_score["stddev"]:
        raise AssertionError(f"stddev {before_score['stddev']} -> "
                             f"{after_score['stddev']}")

    # the host-clock split of one more balancer pass, every piece a lap
    # of that pass: update(), calc_pg_upmaps's own timings (clone,
    # _build_pgs_by_osd, search), apply_incremental, update() again
    total_pgs = m.pools[0].size * m.pools[0].pg_num
    n_in = sum(1 for o in range(m.max_osd) if m.is_in(o))
    ratio = UPMAP_DEVIATION / max(1.0, total_pgs / n_in)
    inc2 = Incremental(epoch=m.epoch + 1)
    laps = {}
    t_pass = time.monotonic()
    mp = om.OSDMapMapping()
    mp.update(m)
    torch.cuda.synchronize()
    split = {"update": time.monotonic() - t_pass}
    n = bal.calc_pg_upmaps(m, ratio, UPMAP_MAX, {0}, inc2,
                           rng=random.Random(0), mapping=mp, timings=laps)
    split.update({k: t1 - t0 for k, (t0, t1) in laps.items()})
    t0 = time.monotonic()
    m.apply_incremental(inc2)
    split["apply_incremental"] = time.monotonic() - t0
    t0 = time.monotonic()
    om.OSDMapMapping().update(m)
    torch.cuda.synchronize()
    split["update_after"] = time.monotonic() - t0
    wall_pass = time.monotonic() - t_pass
    if inc2.new_pg_upmap_items != items or n != len(items):
        raise AssertionError("the split's balancer pass differs from the "
                             "tool's")
    share = k3_ms / 1e3 / wall
    print(f"phase 13: osdmaptool --upmap --test-map-pgs at {N_OSD} OSDs / "
          f"{PG_NUM} PGs: {wall:.3f} s on the host clock; prepared "
          f"{len(items)}/{UPMAP_MAX} changes; every upmapped PG on 3 hosts "
          f"and == scalar pg_to_up_acting_osds; score stddev "
          f"{before_score['stddev']} -> {after_score['stddev']}; K3 "
          f"launches {launches}, {k3_ms:.3f} ms by CUDA events in that run, "
          f"{share:.4f} of its wall, on {name_power}")
    print(f"phase 13: split of one more pass, each piece a lap of it: "
          f"{wall_pass:.3f} s = "
          + ", ".join(f"{k} {v:.3f} s" for k, v in split.items())
          + f", the rest {wall_pass - sum(split.values()):.3f} s")

    # card against CPU at 1,000 OSDs: the same command file, byte for byte
    small = str(work / "om_small.json")
    run_cli(osdmaptool.main, ["--createsimple", str(CROSS_OSD),
                              "--osds-per-host", str(OSDS_PER_HOST),
                              "--pg-num", str(CROSS_PG), small])
    files, cross = {}, {}
    for device in ("cuda", "cpu"):
        out = str(work / f"upmap_{device}.txt")
        _, _, cross[device] = run_cli(osdmaptool.main, [
            small, "--upmap", out, "--upmap-max", str(UPMAP_MAX),
            "--upmap-deviation", str(UPMAP_DEVIATION), "--device", device])
        files[device] = Path(out).read_bytes()
    if files["cuda"] != files["cpu"] or not files["cuda"]:
        raise AssertionError("--upmap on the card and on the CPU differ")
    wall_phase = time.monotonic() - t_phase
    print(f"phase 13: --upmap at {CROSS_OSD} OSDs / {CROSS_PG} PGs: card "
          f"{cross['cuda']:.3f} s, CPU {cross['cpu']:.3f} s, command files "
          f"equal ({len(files['cuda'])} B); phase {wall_phase:.1f} s")
    return {"launches": launches, "wall_s": wall, "split_s": split,
            "split_wall_s": wall_pass, "k3_ms": k3_ms, "k3_share": share, "changes": len(items),
            "stddev": [before_score["stddev"], after_score["stddev"]],
            "cross_s": cross, "phase_s": wall_phase}


def host_us_per_call(fn, calls: int = 2000) -> float:
    """Host-clock microseconds per call of `fn` over `calls` calls in a
    row, after a warmup, up to a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def launch_cost(ec, bm, devguard, dev) -> dict:
    """What each layer above K1 costs the host per call, on one staged
    stripe of 4 KiB chunks (the kernel takes microseconds, so the host
    sets the pace): the kernel wrapper, the operator's launch(), the
    plugin's encode_batch with the guard off, and with it on."""
    x = torch.randint(0, 256, (1, K, 4096), dtype=torch.uint8, device=dev)
    op = ec._encode_mm
    cost = {"gf_matmul_cuda": host_us_per_call(
                lambda: bm.gf_matmul_cuda(op.tables, x, M)),
            "operator_launch": host_us_per_call(lambda: op.launch(x)),
            "encode_batch_guard_off": host_us_per_call(
                lambda: ec.encode_batch(x))}
    devguard.enable()
    try:
        cost["encode_batch_guard_on"] = host_us_per_call(
            lambda: ec.encode_batch(x))
    finally:
        devguard.disable()
    return cost


def guard_phase(ec, ecutil, logical: bytes, placement, repair_state,
                mapfile: str, dev, name_power: str) -> dict:
    """Phase 14: phases 5, 8, 10 and 12 once more under the device guard,
    then a deliberate sync inside a region, which must raise."""
    from ceph_tpu_torch.common import devguard
    from ceph_tpu_torch.crush import batch as cb
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import mapping as om
    from ceph_tpu_torch.tools import crushtool

    t_phase = time.monotonic()
    cost = launch_cost(ec, bm, devguard, dev)
    devguard.reset()
    devguard.enable()
    bm.reset_launches()
    cb.reset_launches()
    try:
        sinfo = ecutil.StripeInfo(K, K * CHUNK)
        # phase 5's round trip, then one on a fresh plugin, whose decode
        # operator is built inside ecutil's guarded region
        for code in (ec, registry.factory("tpu", {"k": str(K), "m": str(M)})):
            obj = logical if code is ec else logical[:8 * K * CHUNK]
            shards = ecutil.encode(sinfo, code, obj)
            degraded = {i: v for i, v in shards.items() if i not in ERASURES}
            if ecutil.decode_concat(sinfo, code, degraded) != obj:
                raise AssertionError("guarded ECUtil round trip differs")
        mapping = om.OSDMapMapping()
        mapping.update(placement)
        st = repair_state
        for bufs, want in zip(st["bufs"], st["want"]):
            if ecutil.compiled_repair_streams(st["ec"], st["plan"], st["cs"],
                                              bufs)[0] != want:
                raise AssertionError("guarded repair differs")
        # and a fresh plugin instance, whose cache compiles the plan once
        fresh = registry.factory(st["plugin"], dict(REPAIR_CODES[0][1]))
        if ecutil.compiled_repair_streams(fresh, st["plan"], st["cs"],
                                          st["bufs"][0])[0] != st["want"][0]:
            raise AssertionError("guarded repair on a fresh plugin differs")
        run_cli(crushtool.main, ["-i", mapfile, "--test", "--show-statistics",
                                 "--max-x", str(TOOL_GUARD_X - 1), "--rule",
                                 "0", "--num-rep", "3"])
        stats = devguard.stats()
        if any(s["recompiles"] for s in stats.values()) or \
                stats.get("repairc", {}).get("compiles") != 1:
            raise AssertionError(f"devguard compile stats: {stats}")
        launches = {**bm.LAUNCHES, **cb.LAUNCHES}
        if not (launches["gf_matmul"] and launches["crush_do_rule"]):
            raise AssertionError(f"guarded run launched {launches}")
        probe = torch.ones(4, device=dev)
        try:
            with devguard.guard_transfers(dev):
                probe.sum().item()
        except RuntimeError as ex:
            caught = str(ex).splitlines()[0]
        else:
            raise AssertionError(".item() inside guard_transfers() passed")
        if torch.cuda.get_sync_debug_mode() != 0:
            raise AssertionError("the sync debug mode was not restored")
    finally:
        devguard.disable()
    wall = time.monotonic() - t_phase
    print(f"phase 14: under devguard: ECUtil round trips ({len(logical)} B "
          f"and a fresh plugin), OSDMapMapping.update(), {len(st['bufs'])} "
          f"compiled repairs of {st['plugin']}, crushtool --test rule 0 at "
          f"{TOOL_GUARD_X} x: no guard error; launches {launches}; compile "
          f"stats {stats}; .item() inside a region raised ({caught!r}); "
          f"phase {wall:.1f} s")
    print("phase 14: host us per call on one staged 8 x 4 KiB stripe: "
          + ", ".join(f"{k} {v:.2f}" for k, v in cost.items())
          + f" on {name_power}")
    return {"launches": launches, "wall_s": wall, "stats": stats,
            "host_us_per_call": cost}


# ---------------------------------------------------------------------------
# The multi-device EC mesh, the fabric and the benchmark CLI: phases 15-17

def mesh_phase(ec, state: dict, name_power: str, dev) -> dict:
    """Phase 15: the one-card mesh (["cuda:0"] * 8) at the main path's
    shapes for shard_ways 1, 2 and 4: parity against encode_batch's and
    the plain version, the decode of [1, 9] at full width, every
    two-erasure pattern at S = MESH_PATTERN_S, K1's launches; then the
    mesh encode beside encode_batch and K1 at the narrowest slice."""
    from ceph_tpu_torch.dist import MeshECCoder, make_mesh
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm

    t_phase = time.monotonic()
    n = K + M
    data, parity = state["data"], state["parity"]
    full = torch.cat([data, parity], dim=1)
    plain = bm.gf_matmul_plain(ec._encode_mm.mat_t, data)
    di = state["decode_index"]
    data_np = data.cpu().numpy()
    survivors_np = state["survivors"].cpu().numpy()
    small_np = full[:MESH_PATTERN_S].cpu().numpy()
    patterns = list(itertools.combinations(range(n), 2))
    coders, sharded = {}, {}
    calls = 0
    bm.reset_launches()
    for w in MESH_WAYS:
        coder = MeshECCoder(K, M, make_mesh(8, shard_ways=w, k=K,
                                            devices=[dev] * 8),
                            encode_matrix=ec.encode_matrix)
        x = coder.shard_data(data_np)
        out = coder.encode(x)
        calls += 1
        s = STRIPES // coder.mesh.devices.shape[0]
        for i, row in enumerate(out.blocks):
            if not torch.equal(row[0], parity[i * s:(i + 1) * s]) or \
                    not torch.equal(row[0], plain[i * s:(i + 1) * s]):
                raise AssertionError(f"mesh parity differs at shard_ways {w}"
                                     f" stripe row {i}")
        rec = coder.decode(di, ERASURES, coder.shard_data(survivors_np))
        calls += 1
        for i, row in enumerate(rec.blocks):
            if not torch.equal(row[0], full[i * s:(i + 1) * s, ERASURES]):
                raise AssertionError(f"mesh decode of {ERASURES} differs at "
                                     f"shard_ways {w}")
        s = MESH_PATTERN_S // coder.mesh.devices.shape[0]
        for erasures in patterns:
            idx = [i for i in range(n) if i not in erasures][:K]
            rec = coder.decode(idx, list(erasures), coder.shard_data(
                np.ascontiguousarray(small_np[:, idx])))
            calls += 1
            for i, row in enumerate(rec.blocks):
                if not torch.equal(row[0], full[i * s:(i + 1) * s,
                                               list(erasures)]):
                    raise AssertionError(f"mesh decode of {erasures} differs"
                                         f" at shard_ways {w}")
        coders[w], sharded[w] = coder, x
    torch.cuda.synchronize()
    launches = bm.LAUNCHES["gf_matmul"]
    if launches == 0 or launches != 8 * calls or \
            bm.LAUNCHES["gf_decode_select"]:
        raise AssertionError(f"mesh: {launches} K1 launches for {calls} mesh "
                             "steps of 8 positions")
    print(f"phase 15: mesh over ['cuda:0'] * 8, shard_ways {MESH_WAYS}, "
          f"{STRIPES} x 1 MiB: parity == encode_batch == plain, decode of "
          f"{ERASURES} == lost chunks, all {len(patterns)} two-erasure "
          f"patterns at S = {MESH_PATTERN_S} == lost chunks; K1 launches "
          f"{launches} for {calls} mesh steps (8 positions each)")

    mesh_ms = {w: time_ms(lambda c=coders[w], x=sharded[w]: c.encode(x))
               for w in MESH_WAYS}
    batch_ms = time_ms(lambda: ec.encode_batch(data))
    # K1 at the narrowest column slice: shard_ways 4, stripe row 0
    w = max(MESH_WAYS)
    block = sharded[w].blocks[0][0]
    op = coders[w]._op("encode", coders[w].encode_matrix[K:], 0, dev)
    s_n, k_in, n_b = block.shape
    narrow_ms = device_ms(lambda: bm.gf_matmul_cuda(op.tables, block, M))
    narrow_plain_ms = time_ms(lambda: bm.gf_matmul_plain(op.mat_t, block),
                              reps=2, repeats=5)
    err = max_err(bm.gf_matmul_cuda(op.tables, block, M),
                  bm.gf_matmul_plain(op.mat_t, block))
    if err:
        raise AssertionError("K1 differs from plain at the narrow slice")
    narrow_bytes = s_n * (k_in + M) * n_b
    narrow_bound = narrow_bytes / HBM_BYTES_PER_S * 1e3
    wall = time.monotonic() - t_phase
    print(f"phase 15: mesh encode per {STRIPES} x 1 MiB by CUDA events: "
          + ", ".join(f"shard_ways {w} {t:.4f} ms" for w, t in
                      mesh_ms.items())
          + f"; encode_batch (one launch) {batch_ms:.4f} ms; K1 at the "
          f"narrow slice ({s_n}, {k_in}, {n_b}) -> r={M}: {narrow_ms:.4f} ms "
          f"on the card, bound {narrow_bound:.4f} ms by bytes "
          f"({narrow_bound / narrow_ms:.2f} of it), plain "
          f"{narrow_plain_ms:.4f} ms; phase {wall:.1f} s on {name_power}")
    return {"launches_mesh": launches, "mesh_steps": calls,
            "mesh_ms": {str(w): t for w, t in mesh_ms.items()},
            "mesh_encode_batch_ms": batch_ms,
            "narrow_shape": [s_n, k_in, n_b, M], "narrow_ms": narrow_ms,
            "narrow_bound_ms": narrow_bound, "narrow_bound_by": "bytes",
            "narrow_plain_ms": narrow_plain_ms, "max_abs_err_mesh": err,
            "phase_s": wall}


def fabric_phase(ec, ecutil, name_power: str, dev) -> dict:
    """Phase 16: ICIFabric over ["cuda:0"] * 8 with the `tpu` plugin on
    the card: FABRIC_OBJECTS objects of 4 MiB (stripe unit 4096 B); half
    staged first, then 12 threads fetch every shard of those while 2
    threads stage the other half and fetch their shards, as the
    reference's concurrency test does.  Every stream equals ecutil.encode;
    nothing stays staged after release."""
    import threading

    from ceph_tpu_torch.dist import ICIFabric
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm

    t_phase = time.monotonic()
    n = K + M
    cs = ec.get_chunk_size(K * STRIPE_UNIT)
    sinfo = ecutil.StripeInfo(K, K * cs)
    rng = np.random.default_rng(SEED + 3)
    objs = [rng.integers(0, 256, REPAIR_OBJECT, dtype=np.uint8).tobytes()
            for _ in range(FABRIC_OBJECTS)]
    fab = ICIFabric(devices=[dev] * 8)
    if not fab.supports(ec):
        raise AssertionError("the fabric refuses the tpu plugin")
    stage_s, fetch_s, results, errors = [], [], {}, []
    lock = threading.Lock()

    def stage(i):
        t0 = time.monotonic()
        fab.stage_encode(("obj", i), ec, objs[i], cs)
        with lock:
            stage_s.append(time.monotonic() - t0)

    def fetch(i, shard):
        t0 = time.monotonic()
        out = fab.fetch_chunk(("obj", i), shard)
        with lock:
            fetch_s.append(time.monotonic() - t0)
            results[(i, shard)] = out

    def guarded(fn, *args):
        try:
            fn(*args)
        except BaseException as ex:     # noqa: BLE001 — raised below
            with lock:
                errors.append(ex)

    def fetcher(shard):
        for i in range(FABRIC_OBJECTS // 2):
            guarded(fetch, i, shard)

    def stager(first):
        for i in range(first, FABRIC_OBJECTS, 2):
            guarded(stage, i)
            for shard in range(n):
                guarded(fetch, i, shard)

    bm.reset_launches()
    for i in range(FABRIC_OBJECTS // 2):
        stage(i)
    threads = [threading.Thread(target=fetcher, args=(s,)) for s in range(n)]
    threads += [threading.Thread(target=stager, args=(FABRIC_OBJECTS // 2 + j,))
                for j in range(2)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    concurrent_s = time.monotonic() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("fabric stage/fetch deadlocked")
    if errors:
        raise AssertionError(f"fabric errors: {errors[:3]}")
    launches = bm.LAUNCHES["gf_matmul"]
    t0 = time.monotonic()
    for i, obj in enumerate(objs):
        want = ecutil.encode(sinfo, ec, obj)
        for shard in range(n):
            if results[(i, shard)] != want[shard]:
                raise AssertionError(f"fabric object {i} shard {shard} "
                                     "differs from ecutil.encode")
    check_s = time.monotonic() - t0
    for i in range(FABRIC_OBJECTS):
        fab.release(("obj", i))
    if fab.staged_count() != 0 or fab.stats["staged"] != FABRIC_OBJECTS or \
            fab.stats["fetched"] != FABRIC_OBJECTS * n:
        raise AssertionError(f"fabric stats {fab.stats}, staged "
                             f"{fab.staged_count()}")
    if launches != 8 * FABRIC_OBJECTS:
        raise AssertionError(f"fabric: {launches} K1 launches for "
                             f"{FABRIC_OBJECTS} stages of 8 positions")
    wall = time.monotonic() - t_phase

    def summary(ts):
        return (f"median {statistics.median(ts) * 1e3:.3f} ms, max "
                f"{max(ts) * 1e3:.3f} ms, sum {sum(ts):.3f} s")
    print(f"phase 16: ICIFabric over ['cuda:0'] * 8: {FABRIC_OBJECTS} x "
          f"{REPAIR_OBJECT} B objects (chunk {cs} B), 12 fetch threads + 2 "
          f"stage threads {concurrent_s:.3f} s; every fetched stream == "
          f"ecutil.encode ({check_s:.1f} s); staged_count 0 after release; "
          f"K1 launches {launches}; host clock per stage {summary(stage_s)}; "
          f"per fetch {summary(fetch_s)}; phase {wall:.1f} s on {name_power}")
    return {"launches": launches, "stage_s": stage_s, "fetch_s": fetch_s,
            "concurrent_s": concurrent_s, "phase_s": wall}


def bench_phase(name_power: str) -> dict:
    """Phase 17: the ceph_erasure_code_benchmark CLI on the card for the
    tpu and isa plugins, k=8 m=4, 1 MiB, both workloads; decode runs
    random two-erasure patterns through the CLI's byte gate."""
    from ceph_tpu_torch.tools import ec_bench

    t_phase = time.monotonic()
    rows = {}
    for plugin in ("tpu", "isa"):
        for workload in ("encode", "decode"):
            argv = ["--plugin", plugin, "--workload", workload, "--size",
                    str(OBJECT), "--iterations", str(BENCH_ITERATIONS),
                    "--parameter", f"k={K}", "--parameter", f"m={M}"]
            if workload == "decode":
                argv += ["--erasures", "2"]
            out, _, _ = run_cli(ec_bench.main, argv)
            seconds, kib = out.strip().splitlines()[-1].split("\t")
            seconds = float(seconds)
            mbps = OBJECT * BENCH_ITERATIONS / seconds / 1e6
            rows[f"{plugin}/{workload}"] = {"seconds": seconds, "kib": kib,
                                            "MBps": mbps}
            print(f"phase 17: ec_bench --plugin {plugin} --workload "
                  f"{workload} k={K} m={M} --size {OBJECT} --iterations "
                  f"{BENCH_ITERATIONS}: {seconds:.6f} s\t{kib} KiB, "
                  f"{mbps:.1f} MB/s on {name_power}")
    wall = time.monotonic() - t_phase
    print(f"phase 17: phase {wall:.1f} s")
    return {"rows": rows, "phase_s": wall}


# ---------------------------------------------------------------------------
# The EC placement group's data plane: phase 18

EC_PG_OBJECTS = 64               # 4 MiB objects through ECBackend, per code
EC_PG_RMW = 16                   # objects given an unaligned overwrite
EC_PG_PATCH = 100 << 10          # 100 KiB
EC_PG_KILLED = [1, 9]
PGID = "1.0"


@contextlib.contextmanager
def k1_events(bm):
    """Within the block, every K1 launch is bracketed by CUDA events;
    yields the list of (start, end) pairs.  The launch itself, and its
    count, are the wrapper's."""
    pairs = []
    launch = bm.gf_matmul_cuda

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    bm.gf_matmul_cuda = timed
    try:
        yield pairs
    finally:
        bm.gf_matmul_cuda = launch


class ECPG:
    """One EC placement group of the port: a MemStore and an ECPGShard per
    shard, wired to the primary's ECBackend (osd.0, shard 0) directly, as
    tests/test_ec_backend.py wires them.  Counts the full-chunk rebuilds
    the backend falls back to."""

    def __init__(self, ec, fabric=None):
        from ceph_tpu_torch import store
        from ceph_tpu_torch.common.perf_counters import PerfCounters
        from ceph_tpu_torch.msg import messages
        from ceph_tpu_torch.osd import ec_backend, pg_types

        self.messages, self.store, self.pg_types = messages, store, pg_types
        self.cid = ec_backend.pg_cid(PGID)
        self.k = ec.get_data_chunk_count()
        self.n = ec.get_chunk_count()
        self.stores = [store.MemStore() for _ in range(self.n)]
        self.shards = [ec_backend.ECPGShard(PGID, s, self.stores[s], self.k,
                                            self.n - self.k, fabric=fabric)
                       for s in range(self.n)]
        self.alive = [True] * self.n
        self.perf = PerfCounters("osd.0")
        for key in ("recovery_bytes_read", "recovery_bytes_rebuilt"):
            self.perf.add_u64_counter(key)
        self.backend = ec_backend.ECBackend(
            PGID, ec, 0, list(range(self.n)), self.shards[0], self._send,
            fabric=fabric)
        self.backend.perf = self.perf
        self.full_rebuilds = 0
        full = self.backend._recover_object_full

        def counted(*args, **kwargs):
            self.full_rebuilds += 1
            return full(*args, **kwargs)

        self.backend._recover_object_full = counted

    def _send(self, shard, msg):
        if not self.alive[shard]:
            return False
        if isinstance(msg, self.messages.ECSubWrite):
            reply = self.shards[shard].handle_sub_write(msg)
            if not self.backend.handle_recovery_write_reply(reply):
                self.backend.handle_sub_write_reply(reply)
        elif isinstance(msg, self.messages.ECSubRead):
            self.backend.handle_sub_read_reply(
                self.shards[shard].handle_sub_read(msg))
        return True

    def write(self, oid: str, off: int, data: bytes) -> None:
        out = []
        self.backend.submit_transaction(oid, [("write", off, data)],
                                        out.append)
        if out != [True]:
            raise AssertionError(f"write of {oid} at {off}: {out}")

    def read(self, oid: str) -> bytes:
        out = {}
        self.backend.objects_read_and_reconstruct(
            {oid: (0, 0)}, lambda r, e: out.update(results=r, errors=e))
        if not out or out["errors"]:
            raise AssertionError(f"read of {oid}: {out.get('errors')}")
        return out["results"][oid]

    def recover(self, oid: str, shard: int) -> None:
        out = []
        self.backend.recover_object(oid, [shard], out.append)
        if out != [True]:
            raise AssertionError(f"recovery of {oid} shard {shard}: {out}")

    def stream(self, shard: int, oid: str) -> bytes:
        return self.stores[shard].read(self.cid,
                                       self.store.ObjectId(oid, shard=shard))

    def kill(self, shard: int, oids) -> None:
        """The shard's OSD is down: peering would mark its objects
        missing."""
        self.alive[shard] = False
        for oid in oids:
            self.backend.peer_missing[shard].add(
                oid, self.pg_types.EVersion(1, 1))

    def revive(self, shard: int) -> None:
        self.alive[shard] = True
        self.backend.peer_missing[shard] = self.pg_types.PGMissing()

    def wipe(self, shard: int, oids) -> None:
        """The shard's chunks are lost (its OSD replaced, the log kept):
        remove them from its store and mark them missing."""
        txn = self.store.Transaction()
        for oid in oids:
            txn.remove(self.cid, self.store.ObjectId(oid, shard=shard))
        self.stores[shard].queue_transaction(txn)
        self.kill(shard, oids)
        self.alive[shard] = True


def write_split(pg: ECPG, oid: str, data: bytes) -> dict:
    """One more 4 MiB write, timed piece by piece on the host clock: the
    merge of old and new bytes, ecutil.encode, the HashInfo crc32c, the
    shard transactions' build, and MemStore applying them (data and log
    transactions of every shard)."""
    from ceph_tpu_torch.osd import ec_backend, ecutil
    from ceph_tpu_torch.store import MemStore

    marks: dict = {}
    apply_s = []
    saved = (ec_backend.ECBackend._encode_write, ecutil.encode,
             ecutil.HashInfo.append, MemStore.queue_transaction)
    enc_write, encode, append, apply = saved

    def t_enc_write(self, op):
        marks["enter"] = time.perf_counter()
        out = enc_write(self, op)
        marks["exit"] = time.perf_counter()
        return out

    def t_encode(*args, **kwargs):
        marks["encode0"] = time.perf_counter()
        out = encode(*args, **kwargs)
        marks["encode1"] = time.perf_counter()
        return out

    def t_append(self, *args, **kwargs):
        marks["crc0"] = time.perf_counter()
        out = append(self, *args, **kwargs)
        marks["crc1"] = time.perf_counter()
        return out

    def t_apply(self, txn):
        t0 = time.perf_counter()
        out = apply(self, txn)
        apply_s.append(time.perf_counter() - t0)
        return out

    ec_backend.ECBackend._encode_write = t_enc_write
    ecutil.encode = t_encode
    ecutil.HashInfo.append = t_append
    MemStore.queue_transaction = t_apply
    try:
        t0 = time.perf_counter()
        pg.write(oid, 0, data)
        total = time.perf_counter() - t0
    finally:
        (ec_backend.ECBackend._encode_write, ecutil.encode,
         ecutil.HashInfo.append, MemStore.queue_transaction) = saved
    split = {"merge": marks["encode0"] - marks["enter"],
             "ecutil.encode": marks["encode1"] - marks["encode0"],
             "hashinfo_crc32c": marks["crc1"] - marks["crc0"],
             "txn_build": marks["exit"] - marks["crc1"],
             "memstore_apply": sum(apply_s)}
    split["other"] = total - (marks["exit"] - marks["enter"]) - sum(apply_s)
    split["total"] = total
    return split


def recover_all(pg: ECPG, ec, objs: dict, bm) -> dict:
    """Phase 18's recovery: shard 0 of every object wiped and rebuilt
    through recover_object.  The signature's program is compiled first
    (its probes run the plugin's own decode, on the card for `tpu`), and
    timed apart; then each rebuild must be one compiled repair (one K1
    launch, one program run) and none a full-chunk rebuild, and the
    rebuilt streams equal those from before the failure.  Returns the
    host time, K1's events time and the read/rebuilt pair."""
    from ceph_tpu_torch.ec.repairc import cache_of, program_for
    from ceph_tpu_torch.osd import ecutil

    before = {oid: pg.stream(0, oid) for oid in objs}
    pg.wipe(0, objs)
    t0 = time.monotonic()
    program_for(ec, ecutil.repair_plan(ec, {0}, set(range(1, pg.n))))
    compile_s = time.monotonic() - t0
    stats = cache_of(ec).stats()
    runs0 = stats["hits"] + sum(stats["compiles"].values())
    launches0 = bm.LAUNCHES["gf_matmul"]
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid in objs:
            pg.recover(oid, 0)
        wall = time.monotonic() - t0
    k1 = events_ms(ev)
    stats = cache_of(ec).stats()
    runs = stats["hits"] + sum(stats["compiles"].values()) - runs0
    launches = bm.LAUNCHES["gf_matmul"] - launches0
    if runs != len(objs) or launches != len(objs) or pg.full_rebuilds:
        raise AssertionError(f"recovery: {runs} compiled repairs, {launches} "
                             f"K1 launches, {pg.full_rebuilds} full "
                             f"rebuilds for {len(objs)} objects")
    for oid in objs:
        if pg.stream(0, oid) != before[oid]:
            raise AssertionError(f"rebuilt shard 0 of {oid} differs")
    perf = pg.perf.dump()
    return {"wall_s": wall, "k1_ms": k1, "compile_s": compile_s,
            "read": perf["recovery_bytes_read"],
            "rebuilt": perf["recovery_bytes_rebuilt"],
            "ratio": perf["recovery_bytes_read"] /
            perf["recovery_bytes_rebuilt"]}


def ec_pg_phase(ec, name_power: str, dev) -> dict:
    """Phase 18: the EC placement group's data plane (ECBackend and
    ECPGShard over the port's MemStores) on the card at the pool shape
    `tpu` k=8 m=4 reed_sol_van, stripe unit 4096 B, 4 MiB objects: writes,
    an unaligned overwrite of 16 objects, reads, a degraded read with two
    shards down, shard 0 recovered; the same recovery for REPAIR_r01.json's
    three codes; the 64 writes again through the fabric."""
    from ceph_tpu_torch.dist import ICIFabric
    from ceph_tpu_torch.ec import registry
    from ceph_tpu_torch.ec.kernels import bitmatmul as bm
    from ceph_tpu_torch.osd import ecutil

    t_phase = time.monotonic()
    rng = np.random.default_rng(SEED + 18)
    objs = {f"obj{i}": rng.integers(0, 256, REPAIR_OBJECT,
                                    dtype=np.uint8).tobytes()
            for i in range(EC_PG_OBJECTS)}
    logical = len(objs) * REPAIR_OBJECT
    n = K + M
    pg = ECPG(ec)
    sinfo = pg.backend.sinfo
    if sinfo.chunk_size != STRIPE_UNIT:
        raise AssertionError(f"chunk {sinfo.chunk_size} B, want {STRIPE_UNIT}")
    rows = {}

    def row(name, nbytes, wall, k1_ms):
        rows[name] = {"MBps": nbytes / wall / 1e6, "wall_s": wall,
                      "k1_ms": k1_ms, "k1_share": k1_ms / 1e3 / wall}
        return rows[name]

    # -- writes, the overwrite, reads ---------------------------------------
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid, data in objs.items():
            pg.write(oid, 0, data)
        wall = time.monotonic() - t0
    row("write", logical, wall, events_ms(ev))
    written = {oid: [pg.stream(s, oid) for s in range(n)] for oid in objs}
    split = write_split(pg, "split", objs["obj0"])
    for i in range(EC_PG_RMW):
        oid = f"obj{i * (EC_PG_OBJECTS // EC_PG_RMW)}"
        off = 1_000_003 + 65_537 * i                 # unaligned to a stripe
        patch = rng.integers(0, 256, EC_PG_PATCH, dtype=np.uint8).tobytes()
        pg.write(oid, off, patch)
        objs[oid] = objs[oid][:off] + patch + objs[oid][off + len(patch):]
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid, data in objs.items():
            if pg.read(oid) != data:
                raise AssertionError(f"read of {oid} differs")
        wall = time.monotonic() - t0
    row("read", logical, wall, events_ms(ev))
    ec_cpu = registry.factory("tpu", {"k": str(K), "m": str(M),
                                      "technique": "reed_sol_van"},
                              device="cpu")
    for oid, data in objs.items():
        want = ecutil.encode(sinfo, ec_cpu, data)
        for s in range(n):
            if pg.stream(s, oid) != want[s]:
                raise AssertionError(f"{oid} shard {s} differs from the plain "
                                     "version's encode")
    # -- degraded read --------------------------------------------------------
    for s in EC_PG_KILLED:
        pg.kill(s, objs)
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid, data in objs.items():
            if pg.read(oid) != data:
                raise AssertionError(f"degraded read of {oid} differs")
        wall = time.monotonic() - t0
    row("degraded_read", logical, wall, events_ms(ev))
    for s in EC_PG_KILLED:
        pg.revive(s)
    # -- recovery of shard 0, then REPAIR_r01.json's codes --------------------
    rec = {"tpu": recover_all(pg, ec, objs, bm)}
    want_ratio = {"tpu": float(K)}
    write_s = {}
    for plugin, profile, ratio in REPAIR_CODES:
        ec2 = registry.factory(plugin, dict(profile))     # the card
        pg2 = ECPG(ec2)
        t0 = time.monotonic()
        for i, data in enumerate(objs.values()):
            pg2.write(f"obj{i}", 0, data)
        write_s[plugin] = time.monotonic() - t0
        rec[plugin] = recover_all(pg2, ec2, {f"obj{i}": None
                                             for i in range(len(objs))}, bm)
        want_ratio[plugin] = ratio
        del pg2
    for code, r in rec.items():
        if r["ratio"] != want_ratio[code]:
            raise AssertionError(f"{code}: read/rebuilt {r['read']}/"
                                 f"{r['rebuilt']} = {r['ratio']}, want "
                                 f"{want_ratio[code]}")
        row(f"rebuild_{code}", r["rebuilt"], r["wall_s"], r["k1_ms"])
    # -- the same writes through the fabric -----------------------------------
    fab = ICIFabric(devices=[dev] * 8)
    for osd in range(n):
        fab.register_resident(osd)
    pg3 = ECPG(ec, fabric=fab)
    rng = np.random.default_rng(SEED + 18)        # the first writes' bytes
    with k1_events(bm) as ev:
        t0 = time.monotonic()
        for oid in written:
            pg3.write(oid, 0, rng.integers(0, 256, REPAIR_OBJECT,
                                           dtype=np.uint8).tobytes())
        wall = time.monotonic() - t0
    row("fabric_write", logical, wall, events_ms(ev))
    for oid, streams in written.items():
        for s in range(n):
            if pg3.stream(s, oid) != streams[s]:
                raise AssertionError(f"fabric {oid} shard {s} differs from "
                                     "the host path's")
    if fab.stats["staged"] != len(written) or fab.staged_count():
        raise AssertionError(f"fabric stats {fab.stats}")
    wall = time.monotonic() - t_phase
    for name, r in rows.items():
        print(f"phase 18: {name} {r['MBps']:.1f} MB/s on the host clock "
              f"({r['wall_s']:.3f} s), K1 {r['k1_ms']:.3f} ms by CUDA events "
              f"({r['k1_share'] * 100:.2f} % of it) on {name_power}")
    print("phase 18: split of one 4 MiB write (host s): " + ", ".join(
        f"{k} {v:.6f}" for k, v in split.items()) + f" on {name_power}")
    print(f"phase 18: ECBackend tpu k={K} m={M} stripe unit {STRIPE_UNIT} B: "
          f"{len(objs)} x {REPAIR_OBJECT} B written, {EC_PG_RMW} x "
          f"{EC_PG_PATCH} B unaligned overwrites, every read == the "
          f"script's bytes, every shard stream == the plain version's "
          f"encode; degraded read with shards {EC_PG_KILLED} down == the "
          f"bytes; shard 0 recovered == before the failure, read/rebuilt " +
          ", ".join(f"{c} {r['ratio']}" for c, r in rec.items()) +
          f", one compiled repair per object, 0 full rebuilds; "
          f"repair compiles (apart) " +
          ", ".join(f"{c} {r['compile_s']:.3f}" for c, r in rec.items()) +
          f" s; {', '.join(c for c, _, _ in REPAIR_CODES)} writes " +
          ", ".join(f"{v:.1f}" for v in write_s.values()) +
          f" s; fabric chunks == the host path's; phase {wall:.1f} s")
    return {"rows": rows, "split_s": split, "write_s": write_s,
            "ratios": {c: r["ratio"] for c, r in rec.items()},
            "phase_s": wall}


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
    logs = _build.build("gf_matmul", "crush_rule")   # both nvcc at once
    print(f"phase 2: built gf_matmul and crush_rule in "
          f"{time.monotonic() - t0:.1f} s")
    log = logs["gf_matmul"]
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
    k3, placement = crush_phases(logs["crush_rule"], name_power, dev)
    kernels.append(k3)
    k1_repair, repair_state = repair_phases(name_power, gen, dev)
    kernels[0].update(k1_repair)

    work = _build.BUILD_DIR / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    tool = crushtool_phase(name_power, dev, work)
    balance = balancer_phase(name_power, dev, work)
    guard = guard_phase(ec, ecutil, data.cpu().numpy().tobytes(), placement,
                        repair_state, tool["mapfile"], dev, name_power)
    k3["max_abs_err"] = max(k3["max_abs_err"], tool["max_abs_err"])
    k3.update({"launches_tester": tool["launches"],
               "launches_balancer": balance["launches"],
               "launches_guarded": guard["launches"]["crush_do_rule"],
               "tester": tool["rows"], "balancer": {
                   k: balance[k] for k in ("wall_s", "split_s",
                                           "split_wall_s", "k3_ms",
                                           "k3_share", "changes", "stddev",
                                           "cross_s")}})
    kernels[0]["launches_guarded"] = guard["launches"]["gf_matmul"]
    kernels[0]["host_us_per_call"] = guard["host_us_per_call"]
    mesh = mesh_phase(ec, state, name_power, dev)
    fabric = fabric_phase(ec, ecutil, name_power, dev)
    bench = bench_phase(name_power)
    bm.reset_launches()
    ec_pg = ec_pg_phase(ec, name_power, dev)
    launches = dict(bm.LAUNCHES)
    print(f"phase 18: launches {launches}")
    if launches["gf_matmul"] == 0:
        raise AssertionError("the EC PG data plane never launched gf_matmul")
    kernels[0].update({k: v for k, v in mesh.items() if k != "phase_s"})
    kernels[0]["launches_fabric"] = fabric["launches"]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    mesh["max_abs_err_mesh"])
    # isa runs on the host and launches no K1: its rows stay on the
    # phase's lines
    kernels[0]["ec_bench"] = {k: v for k, v in bench["rows"].items()
                              if k.startswith("tpu/")}
    kernels[0]["launches_ecbackend"] = launches["gf_matmul"]
    kernels[0]["ecbackend"] = {k: ec_pg[k] for k in ("rows", "split_s",
                                                      "ratios")}
    print(f"chip_smoke: phases 12-14 {tool['wall_s']:.1f} + "
          f"{balance['phase_s']:.1f} + {guard['wall_s']:.1f} s; phases 15-18 "
          f"{mesh['phase_s']:.1f} + {fabric['phase_s']:.1f} + "
          f"{bench['phase_s']:.1f} + {ec_pg['phase_s']:.1f} s; "
          f"{time.monotonic() - t_start:.1f} s in all on {name_power}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
