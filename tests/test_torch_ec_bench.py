"""The port's ceph_erasure_code_benchmark CLI (ceph_tpu_torch.tools.
ec_bench) on the CPU: every plugin, both workloads, the erasure
generators, the `seconds\\tKiB` line against the reference CLI's, and
the decode byte gate."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from ceph_tpu_torch.tools import ec_bench

ROOT = Path(__file__).resolve().parents[1]

PROFILES = {
    "jerasure": ["k=4", "m=2"],
    "isa": ["k=4", "m=2"],
    "tpu": ["k=4", "m=2"],
    "shec": ["k=4", "m=3", "c=2"],
    "lrc": ["k=4", "m=2", "l=3"],
    "clay": ["k=4", "m=2"],
}
SIZE, ITERATIONS = 65536, 3


def argv(plugin: str, *extra: str) -> list[str]:
    out = ["--plugin", plugin, "--size", str(SIZE), "--iterations",
           str(ITERATIONS), "--device", "cpu", *extra]
    for kv in PROFILES[plugin]:
        out += ["--parameter", kv]
    return out


def run(capsys, args: list[str]) -> tuple[float, str]:
    assert ec_bench.main(args) == 0
    seconds, kib = capsys.readouterr().out.strip().splitlines()[-1] \
        .split("\t")
    return float(seconds), kib


@pytest.fixture(scope="module")
def reference_kib():
    """The reference CLI's KiB field per (plugin, workload), from one
    process that runs its main() for each."""
    probe = textwrap.dedent(f"""
        import contextlib, io, json
        from ceph_tpu.tools import ec_bench
        cases = {json.dumps({p: ["--plugin", p, "--size", str(SIZE),
                                 "--iterations", str(ITERATIONS)]
                             + sum((["--parameter", kv] for kv in kvs), [])
                             for p, kvs in PROFILES.items()})}
        out = {{}}
        for plugin, args in cases.items():
            for workload in ("encode", "decode"):
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    ec_bench.main(args + ["--workload", workload])
                out[plugin + "/" + workload] = \\
                    buf.getvalue().strip().split("\\t")[1]
        print(json.dumps(out))
    """)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("workload", ["encode", "decode"])
@pytest.mark.parametrize("plugin", list(PROFILES))
def test_kib_equals_reference(capsys, reference_kib, plugin, workload):
    seconds, kib = run(capsys, argv(plugin, "--workload", workload))
    assert seconds > 0
    assert kib == reference_kib[f"{plugin}/{workload}"]
    assert float(kib) == SIZE / 1024 * ITERATIONS


@pytest.mark.parametrize("generation", ["random", "exhaustive"])
@pytest.mark.parametrize("plugin", list(PROFILES))
def test_decode_erasure_generators(capsys, plugin, generation):
    """Every generated pattern passes the byte gate: one erasure for
    every plugin, two for the codes that survive any two."""
    counts = [1, 2] if plugin != "lrc" else [1]
    for count in counts:
        run(capsys, argv(plugin, "--workload", "decode", "--erasures",
                         str(count), "--erasures-generation", generation))


@pytest.mark.parametrize("plugin", list(PROFILES))
def test_decode_explicit_erased(capsys, plugin):
    seconds, _ = run(capsys, argv(plugin, "--workload", "decode",
                                  "--erased", "0", "--erased", "4"
                                  if plugin != "lrc" else "5"))
    assert seconds > 0


@pytest.mark.parametrize("plugin", list(PROFILES))
def test_corrupted_decode_fails_the_gate(monkeypatch, capsys, plugin):
    """A decode that returns one wrong byte must stop the CLI."""
    from ceph_tpu_torch.ec import registry
    profile = dict(kv.split("=") for kv in PROFILES[plugin])
    cls = type(registry.factory(plugin, profile, device="cpu"))
    decode = cls.decode

    def corrupt(self, want, chunks, *args, **kwargs):
        out = decode(self, want, chunks, *args, **kwargs)
        lost = min(set(range(self.get_chunk_count())) - set(chunks))
        out[lost] = out[lost].copy()
        out[lost][0] ^= 1
        return out

    monkeypatch.setattr(cls, "decode", corrupt)
    with pytest.raises(SystemExit, match="differs after decode"):
        ec_bench.main(argv(plugin, "--workload", "decode"))


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ec_bench.parse_args(["--plugin", "tpu"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ec_bench.run(args)
