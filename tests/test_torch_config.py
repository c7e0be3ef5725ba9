"""The port's config registry and leveled logging against the JAX
package's: the twelve tests of ``tests/test_config.py`` on the port, the
file and environment tiers giving both registries the same values under
one ``STROM_TPU_CONF`` and one environment, and the port's own names."""

import pytest

from nvme_strom_tpu.config import Config as JConfig
from nvme_strom_tpu.config import ConfigError as JConfigError
from nvme_strom_tpu.config import config as jconfig
from nvme_strom_tpu_torch.config import Config, ConfigError, config


@pytest.fixture(autouse=True)
def _port_config():
    """The port's config is its own: snapshot and restore it here."""
    snap = config.snapshot()
    yield
    config.restore(snap)


@pytest.fixture
def clean_env(monkeypatch, tmp_path):
    """No ``STROM_TPU_*`` variable and no config file: each Config() here
    sees only what the test sets."""
    import os
    for k in list(os.environ):
        if k.startswith("STROM_TPU_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("STROM_TPU_CONF", str(tmp_path / "absent.conf"))
    return monkeypatch


def _shared(port, ref):
    """``{name: (port value, reference value)}`` of every registered name
    the two registries share."""
    names = set(port.describe()) & set(ref.describe())
    return {n: (port.get(n), ref.get(n)) for n in sorted(names)}


# -- tests/test_config.py on the port ----------------------------------------

def test_defaults_mirror_reference(clean_env):
    # pgsql GUC defaults (pgsql/nvme_strom.c:1561-1625)
    cfg = Config()
    assert cfg.get("chunk_size") == 16 << 20
    assert cfg.get("buffer_size") == 1 << 30
    assert cfg.get("async_depth") == 8
    assert cfg.get("seq_page_cost") == 0.25
    assert cfg.get("enabled") is True
    assert cfg.get("debug_no_threshold") is False
    assert cfg.get("dma_max_size") == 1 << 20
    assert cfg.get("verbose") == 0 and cfg.get("stat_info") is True
    pairs = _shared(cfg, JConfig())
    assert len(pairs) >= 80
    assert all(p == r for p, r in pairs.values()), \
        {n: v for n, v in pairs.items() if v[0] != v[1]}


def test_size_suffix_parsing():
    config.set("chunk_size", "8m")
    assert config.get("chunk_size") == 8 << 20
    config.set("dma_max_size", "128k")
    assert config.get("dma_max_size") == 128 << 10


def test_pow2_validation():
    with pytest.raises(ConfigError):
        config.set("chunk_size", (16 << 20) + 4096)


def test_buffer_multiple_of_chunk():
    config.set("chunk_size", "1m")
    with pytest.raises(ConfigError):
        config.set("buffer_size", (1 << 20) * 3 + 512)
    config.set("buffer_size", "64m")
    assert config.get("buffer_size") == 64 << 20


def test_bounds():
    for bad in (0, 100000):
        with pytest.raises(ConfigError):
            config.set("async_depth", bad)
        with pytest.raises(JConfigError):
            jconfig.set("async_depth", bad)
    for bad in (-1, 3):
        with pytest.raises(ConfigError):
            config.set("verbose", bad)
        with pytest.raises(JConfigError):
            jconfig.set("verbose", bad)


def test_unknown_var():
    with pytest.raises(ConfigError):
        config.get("nope")
    with pytest.raises(ConfigError):
        config.set("nope", 1)


def test_env_layer(clean_env):
    clean_env.setenv("STROM_TPU_ASYNC_DEPTH", "16")
    assert Config().get("async_depth") == 16 == JConfig().get("async_depth")


def test_file_layer(tmp_path, clean_env):
    conf = tmp_path / "strom_tpu.conf"
    conf.write_text("# comment\nchunk_size = 4m\nverbose = 1\n")
    clean_env.setenv("STROM_TPU_CONF", str(conf))
    cfg = Config()
    assert cfg.get("chunk_size") == 4 << 20
    assert cfg.get("verbose") == 1


def test_bool_parsing():
    for raw, want in [("on", True), ("off", False), ("1", True),
                      ("no", False), ("YES", True), ("false", False)]:
        config.set("enabled", raw)
        jconfig.set("enabled", raw)
        assert config.get("enabled") is want is jconfig.get("enabled")
    with pytest.raises(ConfigError):
        config.set("enabled", "maybe")
    with pytest.raises(JConfigError):
        jconfig.set("enabled", "maybe")


def test_io_backend_validated():
    with pytest.raises(ConfigError):
        config.set("io_backend", "nonsense")
    config.set("io_backend", "threadpool")
    assert config.get("io_backend") == "threadpool"


def test_leveled_logging_gated_by_verbose(capsys):
    """``pr_debug`` needs verbose 2 and ``pr_info`` verbose 1, as in the
    JAX package; ``pr_warn`` and ``pr_error`` always print."""
    from nvme_strom_tpu_torch.log import pr_debug, pr_error, pr_info, pr_warn

    config.set("verbose", 0)
    pr_debug("dbg %d", 1)
    pr_info("inf")
    pr_warn("wrn")
    pr_error("err")
    err = capsys.readouterr().err
    assert "wrn" in err and "err" in err
    assert "dbg" not in err and "inf" not in err

    config.set("verbose", 1)
    pr_debug("dbg1")
    pr_info("inf1")
    err = capsys.readouterr().err
    assert "inf1" in err and "dbg1" not in err

    config.set("verbose", 2)
    pr_debug("dbg2 %s", "x")
    pr_info("inf2")
    err = capsys.readouterr().err
    assert "dbg2 x" in err and "inf2" in err


def test_stats_names_and_values():
    """The counters read as named ints: every name of the reference's
    ``as_arrays`` is a key of the port's snapshot, its value an int."""
    from nvme_strom_tpu.stats import stats as jstats
    from nvme_strom_tpu_torch.stats import stats

    stats.add("nr_ssd2dev", 3)
    jstats.add("nr_ssd2dev", 3)
    names, vals = jstats.as_arrays()
    snap = stats.snapshot()
    assert set(names) <= set(snap)
    assert all(isinstance(snap[n], int) for n in names)
    assert snap["nr_ssd2dev"] >= 3
    assert not [n for n in snap if "debug" in n]


# -- the tiers against the reference -----------------------------------------

def test_file_and_env_tiers_match_the_reference(tmp_path, clean_env):
    """One file and one environment give both registries the same value of
    every shared name: the environment wins over the file, sizes and
    booleans parse alike, a knob's older name sets the one value."""
    conf = tmp_path / "strom_tpu.conf"
    conf.write_text("# tiers\n"
                    "chunk_size = 8m   # a size\n"
                    "async_depth = 16\n"
                    "\n"
                    "enabled = off\n"
                    "cache_bytes = 64m\n"
                    "  seq_page_cost=0.5\n"
                    "io_backend = threadpool\n")
    clean_env.setenv("STROM_TPU_CONF", str(conf))
    clean_env.setenv("STROM_TPU_ASYNC_DEPTH", "32")
    clean_env.setenv("STROM_TPU_STAT_INFO", "no")
    clean_env.setenv("STROM_TPU_VERBOSE", "2")
    clean_env.setenv("STROM_TPU_DMA_MAX_SIZE", "256k")
    clean_env.setenv("STROM_TPU_QOS_DEFAULT_CLASS", "bulk")
    port, ref = Config(), JConfig()
    assert port.get("chunk_size") == 8 << 20
    assert port.get("async_depth") == 32          # the environment wins
    assert port.get("enabled") is False and port.get("stat_info") is False
    assert port.get("tier_ram_bytes") == 64 << 20
    assert port.get("dma_max_size") == 256 << 10
    pairs = _shared(port, ref)
    assert all(p == r for p, r in pairs.values()), \
        {n: v for n, v in pairs.items() if v[0] != v[1]}


def test_env_tier_reads_the_ports_own_names(clean_env):
    clean_env.setenv("STROM_TPU_X64", "1")
    clean_env.setenv("STROM_TPU_TRACE_DIR", "/tmp/traces")
    clean_env.setenv("STROM_TPU_GROUPBY_CUDA_RATIO", "1.5")
    cfg = Config()
    assert cfg.get("x64") is True
    assert cfg.get("trace_dir") == "/tmp/traces"
    assert cfg.get("groupby_cuda_ratio") == 1.5
    for name in ("x64", "trace_dir", "groupby_cuda_ratio"):
        assert name not in JConfig().describe()


def test_h2d_path_is_refused_by_the_file_and_ignored_in_the_env(
        tmp_path, clean_env):
    """``h2d_path`` is the JAX package's PJRT transfer switch: the port has
    no PJRT, so its file tier refuses the line like any unknown name, and
    its environment tier, which reads registered names only, ignores
    ``STROM_TPU_H2D_PATH``."""
    conf = tmp_path / "strom_tpu.conf"
    conf.write_text("chunk_size = 4m\nh2d_path = plain\n")
    clean_env.setenv("STROM_TPU_CONF", str(conf))
    assert JConfig().get("h2d_path") == "plain"
    with pytest.raises(ConfigError, match="unknown config var h2d_path"):
        Config()
    conf.write_text("chunk_size = 4m\n")
    clean_env.setenv("STROM_TPU_H2D_PATH", "plain")
    cfg = Config()
    assert cfg.get("chunk_size") == 4 << 20
    assert "h2d_path" not in cfg.describe()


@pytest.mark.parametrize("text, match", [
    ("chunk_size = 4m\nno_such_knob = 1\n", "unknown config var no_such_knob"),
    ("# ok\nchunk_size 4m\n", r"strom_tpu\.conf:2: expected key = value"),
    ("async_depth = 0\n", "below minimum"),
    ("chunk_size = 3m\n", "power of two"),
])
def test_bad_file_lines_are_refused_by_both(tmp_path, clean_env, text,
                                            match):
    conf = tmp_path / "strom_tpu.conf"
    conf.write_text(text)
    clean_env.setenv("STROM_TPU_CONF", str(conf))
    with pytest.raises(ConfigError, match=match):
        Config()
    with pytest.raises(JConfigError, match=match):
        JConfig()


def test_bad_env_value_raises_as_the_reference(clean_env):
    """A bad ``STROM_TPU_*`` value raises from ``Config()``, so the
    package's import raises as the JAX package's does."""
    clean_env.setenv("STROM_TPU_STAT_INFO", "sometimes")
    with pytest.raises(ConfigError, match="invalid boolean"):
        Config()
    with pytest.raises(JConfigError, match="invalid boolean"):
        JConfig()


def test_describe_returns_the_registry():
    port, ref = config.describe(), jconfig.describe()
    for name in ("verbose", "stat_info"):
        assert port[name].help == ref[name].help
        assert (port[name].minval, port[name].maxval) == \
            (ref[name].minval, ref[name].maxval)
        assert port[name].default == ref[name].default
    assert port["cache_bytes"].alias_of == "tier_ram_bytes"
    assert set(port) - set(ref) == {"x64", "trace_dir",
                                    "groupby_cuda_ratio"}


def test_peek_reads_the_stored_value():
    config.set("stat_info", "off")
    assert config.peek("stat_info") is False
    config.set("stat_info", True)
    assert config.peek("stat_info") is True
