"""The port's option schema, live config and leveled log
(ceph_tpu_torch.common.options and .log) against the JAX package's.

The assertions of tests/test_common.py's option, config and dout cases
run on the port's `Config`, `OPTIONS` and `log`, and each case also runs
the same calls through the reference and compares: parsed values and
their types, what raises, `dump()` at every level and `diff()` after the
same `set`, env and `load_file` calls.  The repository conftest exports
CEPH_TPU_LOCKDEP, CEPH_TPU_RACECHECK, CEPH_TPU_ERRCHECK and
CEPH_TPU_JAXGUARD; both packages read them through the same env layer,
so both diffs carry them alike.
"""
import json
import logging

import pytest

from ceph_tpu.common import log as ref_log
from ceph_tpu.common import options as ref_options
from ceph_tpu_torch.common import log, options
from ceph_tpu_torch.common.options import (Config, OptionLevel, OPTIONS,
                                           _parse_size)

BOTH = [("ref", ref_options), ("port", options)]


def parsed(pkg, name, value):
    """(value, type) of a parse, or the exception type it raised."""
    try:
        v = pkg.OPTIONS[name].parse(value)
    except ValueError:
        return ValueError
    return v, type(v)


@pytest.mark.parametrize("name,value", [
    ("osd_pool_default_size", "5"), ("mon_osd_down_out_interval", "30"),
    ("objectstore_debug_inject_read_err", "yes"),
    ("objectstore_debug_inject_read_err", "0"),
    ("memstore_device_bytes", "4K"), ("osd_pool_default_size", "-1"),
    ("ms_type", "carrier-pigeon"), ("ms_type", "ici"),
    ("osd_debug_inject_dispatch_delay_probability", "1.5"),
    ("osd_debug_inject_dispatch_delay_probability", "0.25"),
    ("log_level", "31"), ("log_level", "20"), ("ec_tpu_backend", "xla"),
    ("ec_tpu_backend", "cuda"), ("upmap_max_deviation", "7")])
def test_option_parse_like_the_reference(name, value):
    assert parsed(options, name, value) == parsed(ref_options, name, value)


def test_option_parse_types():
    assert OPTIONS["osd_pool_default_size"].parse("5") == 5
    assert OPTIONS["mon_osd_down_out_interval"].parse("30") == 30.0
    assert OPTIONS["objectstore_debug_inject_read_err"].parse("yes") is True
    assert OPTIONS["objectstore_debug_inject_read_err"].parse("0") is False
    assert OPTIONS["memstore_device_bytes"].parse("4K") == 4096
    assert _parse_size("2M") == 2 << 20 == ref_options._parse_size("2M")
    assert _parse_size("1.5k") == 1536 == ref_options._parse_size("1.5k")


def test_option_validation():
    with pytest.raises(ValueError):
        OPTIONS["osd_pool_default_size"].parse("-1")   # uint
    with pytest.raises(ValueError):
        OPTIONS["ms_type"].parse("carrier-pigeon")     # enum
    with pytest.raises(ValueError):
        OPTIONS["osd_debug_inject_dispatch_delay_probability"].parse("1.5")


def test_config_get_set_defaults():
    cfgs = {tag: pkg.Config() for tag, pkg in BOTH}
    for cfg in cfgs.values():
        assert cfg.get("osd_pool_default_size") == 3
        cfg.set("osd_pool_default_size", "5")
        assert cfg["osd_pool_default_size"] == 5
        with pytest.raises(KeyError):
            cfg.set("nonexistent_option", 1)
    diff = cfgs["port"].diff()
    assert diff == cfgs["ref"].diff()
    for name in ("lockdep", "jaxguard", "racecheck", "errcheck"):
        diff.pop(name, None)         # the conftest's env layer
    assert diff == {"osd_pool_default_size": 5}


def test_config_observers_fire_on_change():
    seen = {}
    for tag, pkg in BOTH:
        cfg = pkg.Config()
        got = seen[tag] = []
        cfg.observe("upmap_max_deviation",
                    lambda k, v, got=got: got.append((k, v)))
        cfg.set("upmap_max_deviation", 7)
        cfg.set("upmap_max_deviation", 7)   # unchanged -> no second event
        cfg.set("upmap_max_deviation", 2)
        with pytest.raises(KeyError):
            cfg.observe("nonexistent_option", print)
    assert seen["port"] == seen["ref"] == \
        [("upmap_max_deviation", 7), ("upmap_max_deviation", 2)]


def test_config_env_layer(monkeypatch):
    monkeypatch.setenv("CEPH_TPU_OSD_POOL_DEFAULT_PG_NUM", "128")
    monkeypatch.setenv("CEPH_TPU_MS_TYPE", "ici")
    cfg, ref = Config(), ref_options.Config()
    assert cfg.get("osd_pool_default_pg_num") == 128
    assert cfg.dump() == ref.dump() and cfg.diff() == ref.diff()


def test_config_file_layer(tmp_path):
    p = tmp_path / "conf.json"
    p.write_text(json.dumps({"log_level": 10, "ms_type": "ici",
                             "osd_mclock_scrub_lim": "50",
                             "memstore_device_bytes": "2G"}))
    cfg, ref = Config(), ref_options.Config()
    cfg.load_file(str(p))
    ref.load_file(str(p))
    assert cfg.get("log_level") == 10
    assert cfg.get("ms_type") == "ici"
    assert cfg.dump() == ref.dump()
    assert cfg.diff() == ref.diff()
    assert {k: cfg.diff()[k] for k in ("log_level", "ms_type",
                                       "osd_mclock_scrub_lim",
                                       "memstore_device_bytes")} == \
        {"log_level": 10, "ms_type": "ici", "osd_mclock_scrub_lim": 50.0,
         "memstore_device_bytes": 2 << 30}
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"ms_type": "carrier-pigeon"}))
    for c in (Config(), ref_options.Config()):
        with pytest.raises(ValueError):
            c.load_file(str(bad))


def test_config_dump_levels():
    cfg, ref = Config(), ref_options.Config()
    basic = cfg.dump(OptionLevel.BASIC)
    assert "osd_pool_default_size" in basic
    assert "mon_min_osdmap_epochs" not in basic
    assert set(cfg.dump()) == set(OPTIONS) == set(ref_options.OPTIONS)
    for level in OptionLevel:
        assert cfg.dump(level) == \
            ref.dump(ref_options.OptionLevel(level.value))
    assert cfg.dump() == ref.dump()


def test_log_level_observer_drives_the_default_level():
    """global_config() installs the `log_level` observer in both
    packages: setting it moves the default gather level."""
    cfgs = [(options.global_config(), log), (ref_options.global_config(),
                                             ref_log)]
    old = [cfg["log_level"] for cfg, _ in cfgs]
    try:
        for cfg, mod in cfgs:
            assert mod._default_level == cfg["log_level"]
            assert not mod.dout("nosuchsubsys", 5)
            cfg.set("log_level", 5)
            assert mod._default_level == 5
            assert mod.dout("nosuchsubsys", 5)
            assert not mod.dout("nosuchsubsys", 6)
    finally:
        for (cfg, _), v in zip(cfgs, old):
            cfg.set("log_level", v)
    assert log._default_level == ref_log._default_level


def test_dout_gating(capsys):
    log.set_subsys_level("osd", 1)
    sink = log.dout("osd", 20)
    assert not sink            # gated off -> no-op sink
    sink.write("should not appear")
    log.set_subsys_level("osd", 20)
    assert log.dout("osd", 20)
    log.dout("osd", 20).write("deep debug visible")
    err = capsys.readouterr().err
    assert "deep debug visible" in err
    assert "should not appear" not in err
    log.set_subsys_level("osd", 1)


def test_log_lines_like_the_reference(capsys):
    """The same lines through both packages: the same format but the
    logger's name, the level letter of the reference's mapping (0 ->
    E, 1 -> I, deeper -> D), and derr as level 0."""
    got = {}
    for tag, mod in (("ref", ref_log), ("port", log)):
        mod.set_subsys_level("vstartt", 10)
        try:
            mod.derr("vstartt").write("err %d", 0)
            mod.dout("vstartt", 1).write("info %s", "x")
            mod.dout("vstartt", 10).write("debug")
            mod.dout("vstartt", 11).write("dropped")
        finally:
            mod.set_subsys_level("vstartt", 1)
        lines = capsys.readouterr().err.splitlines()
        got[tag] = [ln.split(" ", 2)[2] for ln in lines]
    assert got["ref"] == [ln.replace("ceph_tpu_torch.", "ceph_tpu.")
                          for ln in got["port"]]
    assert got["port"] == ["ceph_tpu_torch.vstartt E err 0",
                           "ceph_tpu_torch.vstartt I info x",
                           "ceph_tpu_torch.vstartt D debug"]
    lg = logging.getLogger("ceph_tpu_torch.vstartt")
    assert lg.propagate is False and lg.handlers == [log._handler]


@pytest.mark.parametrize("env", [{"CEPH_TPU_OSD_POOL_DEFAULT_SIZE": "bogus"},
                                 {"CEPH_TPU_LOG_LEVEL": "-1"},
                                 {"CEPH_TPU_MS_TYPE": "grpc"}])
def test_env_values_checked_like_the_reference(monkeypatch, env):
    """A malformed env value of an option fails Config() in both
    packages alike; a valid one is read alike."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        want = ref_options.Config().dump()
    except ValueError:
        with pytest.raises(ValueError):
            Config()
    else:
        assert Config().dump() == want
