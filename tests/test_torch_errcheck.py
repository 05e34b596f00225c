"""The port's errcheck (ceph_tpu_torch.common.errcheck) held to the
reference's.

The eight cases of tests/test_errcheck.py run twice in one process: the
reference's hook (armed for this suite) widened to one probe package,
the port's hook armed in a fixture on a second probe package with the
same source.  Each case compares the two at tolerance 0, with the
package names made equal: fired counters keyed by the concrete
exception type, a module-level handler counted during import, the
coverage report and its never-fired list, the static census of a module
nothing imported, unchanged semantics and tracebacks, a syntax error
raised as the pristine compiler raises it, the dump and `merge_dir`
round trip, and no hook, global or counter when the option is off (a
subprocess).  Two more cases: both hooks in one interpreter each
instrument their own package and neither the other's, and a port daemon
process arms the hook from the environment and dumps its counters to
CEPH_TPU_ERRCHECK_DIR at exit.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from ceph_tpu.common import errcheck as ref_errcheck
from ceph_tpu_torch.common import errcheck as port_errcheck

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EC = {"ref": ref_errcheck, "port": port_errcheck}

PROBE_SRC = textwrap.dedent("""\
    def lookup(d, k):
        try:
            return d[k]
        except KeyError:
            return None

    def reraise(x):
        try:
            return 10 // x
        except ZeroDivisionError as ex:
            raise ValueError("zero divisor") from ex

    def cold(x):
        try:
            return x + 1
        except TypeError:
            return -1

    try:
        import _ec_no_such_module_
    except ImportError:
        HAVE_OPT = False
""")


def _mk_pkg(tmp_path, pkgname, src=PROBE_SRC):
    d = tmp_path / pkgname
    d.mkdir()
    (d / "__init__.py").write_text("")
    (d / "mod.py").write_text(src)
    return d


@pytest.fixture
def probes(tmp_path, monkeypatch, request):
    """{kind: (pkg, mod)}: the reference's hook widened to one probe
    package, the port's armed on another; both cleaned out after."""
    out = {}
    monkeypatch.syspath_prepend(str(tmp_path))
    assert ref_errcheck.enabled(), "the suite arms CEPH_TPU_ERRCHECK=1"
    try:
        for kind, ec in EC.items():
            pkg = f"ec_{kind}_probe_{request.function.__name__}"
            _mk_pkg(tmp_path, pkg)
            ec.enable(prefixes=(pkg,))
            out[kind] = (pkg, __import__(f"{pkg}.mod", fromlist=["mod"]))
        yield out
    finally:
        port_errcheck.disable()
        for name in [m for m in sys.modules
                     if m.split(".")[0].startswith("ec_")
                     and "_probe_" in m]:
            del sys.modules[name]


def norm(pkg: str, obj):
    """`obj` with the probe package's name replaced by PKG."""
    return json.loads(json.dumps(obj, default=repr).replace(pkg, "PKG"))


def counts(kind, pkg):
    return sorted((m.replace(pkg, "PKG"), ln, exc, n) for (m, ln, exc), n
                  in EC[kind].counters().items() if m.startswith(pkg))


def both(probes, scenario):
    got = {kind: norm(pkg, scenario(kind, pkg, mod))
           for kind, (pkg, mod) in probes.items()}
    assert got["port"] == got["ref"]
    return got["port"]


def test_fired_handlers_counted_by_exception_type(probes):
    def s(kind, pkg, mod):
        out = [mod.lookup({"a": 1}, "a"), counts(kind, pkg)]
        mod.lookup({}, "x")
        mod.lookup({}, "y")
        with pytest.raises(ValueError):
            mod.reraise(0)
        return out + [counts(kind, pkg)]
    first, import_only, after = both(probes, s)
    assert first == 1
    assert import_only == [["PKG.mod", 21, "ModuleNotFoundError", 1]]
    assert after == [["PKG.mod", 4, "KeyError", 2],
                     ["PKG.mod", 10, "ZeroDivisionError", 1],
                     ["PKG.mod", 21, "ModuleNotFoundError", 1]]


def test_module_level_handler_counts_during_import(probes):
    out = both(probes, lambda kind, pkg, mod: (mod.HAVE_OPT,
                                               counts(kind, pkg)))
    assert out == [False, [["PKG.mod", 21, "ModuleNotFoundError", 1]]]


def test_coverage_report_shape_and_never_fired(probes, tmp_path):
    def s(kind, pkg, mod):
        mod.lookup({}, "x")
        fired = {k: v for k, v in EC[kind].counters().items()
                 if k[0].startswith(pkg)}
        return EC[kind].coverage_report(str(tmp_path / pkg), package=pkg,
                                        fired=fired)
    rep = both(probes, s)
    assert (rep["handlers_total"], rep["handlers_fired"],
            rep["never_fired_count"]) == (4, 2, 2)
    assert rep["modules"]["PKG.mod"] == {"handlers": 4, "fired": 2,
                                         "ratio": 0.5}
    assert rep["never_fired"] == [
        {"module": "PKG.mod", "line": 10, "catches": "ZeroDivisionError"},
        {"module": "PKG.mod", "line": 16, "catches": "TypeError"}]


def test_census_counts_unimported_modules(tmp_path):
    d = _mk_pkg(tmp_path, "ec_cold_pkg")
    (d / "never_imported.py").write_text(PROBE_SRC)
    census = {kind: ec.handler_census(str(d), package="ec_cold_pkg")
              for kind, ec in EC.items()}
    assert census["port"] == census["ref"]
    assert len([1 for m, *_ in census["port"]
                if m == "ec_cold_pkg.never_imported"]) == 4


def test_instrumentation_preserves_semantics(probes):
    def s(kind, pkg, mod):
        with pytest.raises(ValueError) as ei:
            mod.reraise(0)
        out = [type(ei.value.__cause__).__name__,
               ei.traceback[-1].lineno + 1, mod.cold(5)]
        with pytest.raises(TypeError):
            mod.lookup(None, "k")
        return out
    assert both(probes, s) == ["ZeroDivisionError", 11, 6]


def test_syntax_error_modules_fail_like_pristine(probes, tmp_path):
    def s(kind, pkg, mod):
        (tmp_path / pkg / "broken.py").write_text("def f(:\n")
        with pytest.raises(SyntaxError) as ei:
            __import__(f"{pkg}.broken")
        return ei.value.msg, ei.value.lineno
    both(probes, s)


def test_dump_and_merge_dir_roundtrip(probes, tmp_path):
    def s(kind, pkg, mod):
        mod.lookup({}, "x")
        d = tmp_path / f"dumps_{kind}"
        EC[kind].dump(str(d / "errcheck-12345.json"))
        raw = json.loads((d / "errcheck-12345.json").read_text())
        merged = EC[kind].merge_dir(str(d))
        (d / "errcheck-junk.json").write_text("{nope")
        merged2 = EC[kind].merge_dir(str(d))
        return (raw[f"{pkg}.mod\x004\x00KeyError"],
                merged[(f"{pkg}.mod", 4, "KeyError")],
                merged2[(f"{pkg}.mod", 4, "KeyError")])
    assert both(probes, s) == [1, 2, 2]


def _run(code, env_extra=None, drop=("CEPH_TPU_ERRCHECK",
                                     "CEPH_TPU_ERRCHECK_DIR")):
    env = dict(os.environ)
    for k in drop:
        env.pop(k, None)
    env.update(env_extra or {})
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)


def test_off_means_no_hook_no_globals_no_counters():
    """With CEPH_TPU_ERRCHECK unset, importing errcheck and a real
    module of its package leaves the import machinery pristine."""
    outs = {}
    for pkg in ("ceph_tpu", "ceph_tpu_torch"):
        out = _run(textwrap.dedent(f"""\
            import sys
            from {pkg}.common import errcheck
            assert not errcheck.enable_if_configured()
            assert not errcheck.enabled()
            assert not any(type(f).__module__ == errcheck.__name__
                           for f in sys.meta_path), sys.meta_path
            from {pkg}.common import backoff
            assert errcheck.HIT_NAME not in vars(backoff)
            assert errcheck.counters() == {{}}
            print("PRISTINE")
        """))
        outs[pkg] = (out.returncode, out.stdout.strip(), out.stderr)
    assert outs["ceph_tpu_torch"][:2] == outs["ceph_tpu"][:2] == \
        (0, "PRISTINE"), outs


def test_both_hooks_in_one_process_keep_to_their_packages():
    """The reference's hook (prefix ceph_tpu) and the port's (prefix
    ceph_tpu_torch) armed together: each package's modules carry their
    own package's bump and fire into its counters only."""
    out = _run(textwrap.dedent("""\
        from ceph_tpu.common import errcheck as ref
        from ceph_tpu_torch.common import errcheck as port
        assert ref.enable_if_configured() and port.enable_if_configured()
        from ceph_tpu.common import backoff as rb
        from ceph_tpu_torch.common import backoff as pb
        from ceph_tpu.common import crash as rc
        from ceph_tpu_torch.common import crash as pc
        assert vars(rb)[ref.HIT_NAME] is ref._hit
        assert vars(pb)[port.HIT_NAME] is port._hit
        assert port.HIT_NAME not in vars(ref) and \
            ref.HIT_NAME not in vars(port)

        def fail(meta):
            raise ConnectionError("mon unreachable")
        for mod in (rc, pc):
            mod.CrashReporter("osd.0", post=fail).capture(ValueError("x"))
        fired = {ec.__name__: sorted({(m, e) for m, _l, e in
                                      ec.counters()})
                 for ec in (ref, port)}
        assert ("ceph_tpu.common.crash", "ConnectionError") in \
            fired[ref.__name__], fired
        assert ("ceph_tpu_torch.common.crash", "ConnectionError") in \
            fired[port.__name__], fired
        assert all(m.split(".")[0] == "ceph_tpu"
                   for m, _e in fired[ref.__name__]), fired
        assert all(m.split(".")[0] == "ceph_tpu_torch"
                   for m, _e in fired[port.__name__]), fired
        print("SEPARATE")
    """), {"CEPH_TPU_ERRCHECK": "1"})
    assert out.returncode == 0, out.stderr
    assert "SEPARATE" in out.stdout


def test_port_daemon_arms_from_the_environment(tmp_path):
    """`daemon_main` arms the port's hook before its daemon modules
    import and, with CEPH_TPU_ERRCHECK_DIR set, dumps its counters at
    exit (here the mds role exits right after parsing, on a monmap that
    does not exist)."""
    env = dict(os.environ)
    env.update(CEPH_TPU_ERRCHECK="1", CEPH_TPU_ERRCHECK_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent("""\
            import sys
            from ceph_tpu_torch.tools import daemon_main
            from ceph_tpu_torch.common import errcheck
            try:
                daemon_main.main(["mds", "--monmap", "none.json"])
            except FileNotFoundError as ex:
                print("EXIT", ex.filename)
            from ceph_tpu_torch.common import lockdep
            print("ARMED", errcheck.enabled(),
                  errcheck.HIT_NAME in vars(lockdep))
        """)], env=env, capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert "EXIT none.json" in out.stdout
    assert "ARMED True True" in out.stdout
    dumps = [p for p in os.listdir(tmp_path)
             if p.startswith("errcheck-") and p.endswith(".json")]
    assert len(dumps) == 1
    merged = port_errcheck.merge_dir(str(tmp_path))
    assert all(isinstance(n, int) for n in merged.values())
