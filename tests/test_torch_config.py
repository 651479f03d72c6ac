"""The port's config loader (seaweedfs_tpu_torch/util/config.py) against
the JAX package's (seaweedfs_tpu/util/config.py), on the same TOML text:
equal dicts from tomllib and from the subset parser, equal lookups,
byte-equal scaffolds of the sections the port reads, and the same
errors. Tolerance 0: dicts and texts compare equal."""

import pytest

from seaweedfs_tpu.util import config as jax_config
from seaweedfs_tpu_torch.util import config
from torch_teardown import collect_jax_garbage  # noqa: F401

SECTIONS = ("pipeline", "mesh", "flight", "cache", "qos", "tracing",
            "profiler", "telemetry", "slo")

#: every scalar type the subset parser reads, nested tables, comments
SCALARS = """\
# a comment line
top = "level"
[pipeline]
depth = 3                     # trailing comment
batch_bytes = 0x10000
ratio = 0.25
neg = -7
overlapped = false
double_buffer = TRUE
name = "a \\"quoted\\" # not a comment"
path = "C:\\\\tmp"

[mesh.inner]
enabled = true
"""


@pytest.mark.parametrize("name", SECTIONS)
def test_scaffolds_are_byte_equal(name):
    assert config.scaffold(name) == jax_config.scaffold(name)
    assert config.SCAFFOLDS[name] == jax_config.SCAFFOLDS[name]


def test_scaffolds_hold_only_the_sections_the_port_reads():
    assert sorted(config.SCAFFOLDS) == sorted(SECTIONS)
    for name in ("storage", "security"):
        with pytest.raises(KeyError) as err:
            config.scaffold(name)
        assert name in str(err.value)
    # the same KeyError text shape as the JAX package's
    with pytest.raises(KeyError, match="no scaffold named 'nope'; have"):
        config.scaffold("nope")
    with pytest.raises(KeyError, match="no scaffold named 'nope'; have"):
        jax_config.scaffold("nope")


@pytest.mark.parametrize("name", SECTIONS)
def test_load_and_subset_parser_agree_with_jax(tmp_path, name):
    text = config.scaffold(name)
    path = tmp_path / f"{name}.toml"
    path.write_text(text)
    port = config.load(path)
    assert port == jax_config.load(path)
    assert config._parse_toml_subset(text) == \
        jax_config._parse_toml_subset(text) == port
    assert isinstance(port[name], dict) and port[name]


def test_every_scalar_type_parses_as_in_jax(tmp_path):
    path = tmp_path / "all.toml"
    path.write_text(SCALARS)
    sub = config._parse_toml_subset(SCALARS)
    assert sub == jax_config._parse_toml_subset(SCALARS)
    assert sub["pipeline"] == {
        "depth": 3, "batch_bytes": 0x10000, "ratio": 0.25, "neg": -7,
        "overlapped": False, "double_buffer": True,
        "name": 'a "quoted" # not a comment', "path": "C:\\tmp"}
    assert sub["mesh"] == {"inner": {"enabled": True}}
    # tomllib reads the same file the same way in both packages (it
    # rejects the subset parser's upper-case TRUE, so drop that line)
    strict = SCALARS.replace("double_buffer = TRUE\n", "") \
        .replace("batch_bytes = 0x10000", "batch_bytes = 65536")
    path.write_text(strict)
    assert config.load(path) == jax_config.load(path)


def test_missing_file_is_an_empty_dict(tmp_path):
    assert config.load(tmp_path / "none.toml") == {} == \
        jax_config.load(tmp_path / "none.toml")


@pytest.mark.parametrize("dotted,default", [
    ("pipeline.depth", None), ("pipeline", None), ("mesh.inner.enabled", 0),
    ("mesh.inner.nope", "dflt"), ("top", None), ("top.deeper", 5),
    ("nope", None)])
def test_lookup_equals_jax(dotted, default):
    conf = config._parse_toml_subset(SCALARS)
    assert config.lookup(conf, dotted, default) == \
        jax_config.lookup(conf, dotted, default)


@pytest.mark.parametrize("text", [
    "[pipeline]\ndepth\n", "[pipeline]\nname = \"open\n",
    "[pipeline]\ndepth = two\n"])
def test_malformed_lines_raise_the_same_error(text):
    with pytest.raises(ValueError) as port:
        config._parse_toml_subset(text)
    with pytest.raises(ValueError) as ref:
        jax_config._parse_toml_subset(text)
    assert str(port.value) == str(ref.value)
    assert "toml line 2" in str(port.value)
