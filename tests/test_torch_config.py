"""The port's settings validate the deployment's environment as the
reference's do, and its packaging ships every part of it.

* Under the same patched environments (none of the variables, ``ENV=CI``
  alone, each of the 17 required variables missing in turn, all set), the
  reference's ``Config()`` and the port's raise ``ConfigurationError`` or
  not alike, with equal messages, and read equal credentials when they
  build.
* ``python -m binquant_tpu_torch --device cpu`` with neither ``ENV=CI`` nor
  the variables exits with that error before any client is built; the
  offline modes' stub engines read an unset ``ENV`` as ``CI``, as the
  reference's stub does, and validate a non-CI one alike.
* ``pyproject.toml`` lists every directory of the port that holds an
  ``__init__.py`` and ships ``csrc/*.cu``; the JAX package's entries are
  those it had.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tomllib
from pathlib import Path

import pytest
import torch

from binquant_tpu.config import Config as JConfig
from binquant_tpu.exceptions import ConfigurationError as JConfigurationError
from binquant_tpu_torch.config import REQUIRED_VARS
from binquant_tpu_torch.config import Config as TConfig
from binquant_tpu_torch.exceptions import ConfigurationError as TConfigurationError

# small shapes: extra intra-op threads only spin and crowd parallel test workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SETTINGS = {
    "ENV": "production", "BINBOT_API_URL": "http://binbot:8008",
    "TELEGRAM_BOT_TOKEN": "123:abc", "TELEGRAM_USER_ID": "42",
    "BINANCE_API_KEY": "bk", "BINANCE_API_SECRET": "bs", "KUCOIN_API_KEY": "kk",
    "KUCOIN_API_SECRET": "ks", "KUCOIN_API_PASSPHRASE": "kp", "POSTGRES_HOST": "db",
    "POSTGRES_PORT": "6543", "POSTGRES_DB": "signals", "POSTGRES_USER": "bot",
    "POSTGRES_PASSWORD": "pw", "BINANCE_KEY_ID": "kid", "AUTOTRADE": "true",
    "LOG_LEVEL": "WARNING",
}
ACCESSORS = ("autotrade_enabled", "binance_api_key", "binance_api_secret", "kucoin_api_key",
             "kucoin_api_secret", "kucoin_api_passphrase", "postgres_dsn", "binbot_api_url",
             "telegram_bot_token", "telegram_user_id", "log_level", "is_ci")


def _outcome(build):
    try:
        return "built", build()
    except (JConfigurationError, TConfigurationError) as exc:
        return type(exc).__name__, str(exc)


@pytest.fixture
def environ(monkeypatch):
    """A clean slate of the 17 variables; the reference's singleton reset
    before and after."""
    for name in REQUIRED_VARS:
        monkeypatch.delenv(name, raising=False)
    JConfig.reset()
    yield monkeypatch
    JConfig.reset()


def _both(monkeypatch, env: dict):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    JConfig.reset()
    return _outcome(JConfig), _outcome(TConfig)


def test_the_required_variables_are_the_references():
    import binquant_tpu.config as jconfig

    assert REQUIRED_VARS == jconfig._REQUIRED_VARS


@pytest.mark.parametrize(
    "case", ["none", "ci", "ci_lowercase", "all"] + [f"missing_{v}" for v in REQUIRED_VARS]
)
def test_config_raises_where_the_reference_raises(environ, case):
    env = {"none": {}, "ci": {"ENV": "CI"}, "ci_lowercase": {"ENV": "ci"},
           "all": SETTINGS}.get(case)
    if env is None:
        missing = case.removeprefix("missing_")
        env = {k: v for k, v in SETTINGS.items() if k != missing}
    (jkind, jval), (tkind, tval) = _both(environ, env)
    assert jkind == tkind
    if jkind == "built":
        for name in ACCESSORS:
            assert getattr(tval, name) == getattr(jval, name), name
    else:
        assert tkind == "ConfigurationError" and tval == jval
        assert tval.startswith("Missing required environment variables: ")
    assert (jkind == "built") == (case in ("ci", "ci_lowercase", "all"))


@pytest.mark.parametrize("value", ["true", "1", "YES", "false", "0", "no", ""])
def test_autotrade_switch_reads_as_the_reference(environ, value):
    (_, jval), (_, tval) = _both(environ, {**SETTINGS, "ENV": "CI", "AUTOTRADE": value})
    assert tval.autotrade_enabled is jval.autotrade_enabled


def test_an_explicit_env_is_what_the_check_reads(environ):
    with pytest.raises(TConfigurationError, match="Missing required environment variables"):
        TConfig(env="production")
    assert TConfig(env="CI").is_ci


def test_live_boot_fails_before_any_client_is_built(tmp_path):
    """No ``ENV=CI``, none of the variables: the command fails with the
    reference's error, and the binbot client (the first one ``run_live``
    builds) is never constructed."""
    env = {k: v for k, v in os.environ.items() if k not in REQUIRED_VARS}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "binquant_tpu_torch", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1
    last = proc.stderr.strip().splitlines()[-1]
    missing = ", ".join(sorted(REQUIRED_VARS))
    assert last == ("binquant_tpu_torch.exceptions.ConfigurationError: "
                    f"Missing required environment variables: {missing}")
    code = (
        "import binquant_tpu_torch.io.binbot as b\n"
        "def built(*a, **k):\n"
        "    raise SystemExit('a client was built')\n"
        "b.BinbotApi.__init__ = built\n"
        "from binquant_tpu_torch.__main__ import main\n"
        "main(['--device', 'cpu'])\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1 and "ConfigurationError" in proc.stderr
    assert "a client was built" not in proc.stderr


@pytest.mark.parametrize("env", [None, "production"])
def test_stub_engines_validate_as_the_reference_stub(environ, env):
    """``make_stub_engine`` reads an unset ``ENV`` as ``CI`` in both
    packages; a production ``ENV`` without the variables fails in both."""
    from binquant_tpu.io.replay import make_stub_engine as jstub
    from binquant_tpu_torch.io.replay import make_stub_engine as tstub

    if env is not None:
        environ.setenv("ENV", env)
    kw = dict(capacity=8, window=96)
    ref = _outcome(lambda: jstub(**kw, delivery=False))
    environ.delenv("ENV", raising=False)  # the reference's stub set it
    if env is not None:
        environ.setenv("ENV", env)
    port = _outcome(lambda: tstub(**kw, delivery=False, fanout=False, device="cpu"))
    assert ref[0] == port[0]
    if ref[0] != "built":
        assert ref[1] == port[1]


def _port_packages() -> list[str]:
    pkg = ROOT / "binquant_tpu_torch"
    return sorted(
        ".".join(p.parent.relative_to(ROOT).parts) for p in pkg.rglob("__init__.py")
    )


def test_pyproject_ships_every_port_package_and_the_kernel_source():
    project = tomllib.loads((ROOT / "pyproject.toml").read_text())
    tool = project["tool"]["setuptools"]
    listed = tool["packages"]
    port = [p for p in listed if p.split(".")[0] == "binquant_tpu_torch"]
    assert sorted(port) == _port_packages()
    assert {"binquant_tpu_torch.tools", "binquant_tpu_torch.obs",
            "binquant_tpu_torch.fanout"} <= set(port)
    data = tool["package-data"]["binquant_tpu_torch"]
    shipped = {p for pattern in data for p in (ROOT / "binquant_tpu_torch").glob(pattern)}
    assert ROOT / "binquant_tpu_torch" / "csrc" / "qtail.cu" in shipped
    assert sorted(p for p in listed if p.split(".")[0] == "binquant_tpu") == [
        "binquant_tpu", "binquant_tpu.engine", "binquant_tpu.io", "binquant_tpu.ops",
        "binquant_tpu.oracle", "binquant_tpu.parallel", "binquant_tpu.regime",
        "binquant_tpu.strategies",
    ]
    docker = (ROOT / "Dockerfile").read_text()
    assert "COPY binquant_tpu_torch ./binquant_tpu_torch" in docker
