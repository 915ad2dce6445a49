"""The port's market simulator (``binquant_tpu_torch/io/market_sim.py``)
against the reference's (``binquant_tpu/io/market_sim.py``) on the CPU:
the GARCH path, every array of :func:`simulate_market` bit for bit at
small configurations (events on and off, one symbol, a cascade window too
short to place), and :func:`write_market_file`'s bytes (plain and, after
decompression, gzipped)."""

from __future__ import annotations

import gzip

import numpy as np
import pytest
import torch

from binquant_tpu.io import market_sim as ref
from binquant_tpu_torch.io import market_sim as port

torch.set_num_threads(1)

CONFIGS = {
    "small": dict(n_symbols=6, hours=30, seed=3),
    "events_early": dict(n_symbols=5, hours=12, seed=11, event_start_hour=2, n_pumps=3),
    "one_symbol": dict(n_symbols=1, hours=8, seed=5, event_start_hour=1),
    "no_cascade_room": dict(n_symbols=4, hours=3, seed=2, event_start_hour=2, n_cascades=2),
    "heavy_tails": dict(n_symbols=3, hours=6, seed=9, t_df=2.5, garch_alpha=0.2,
                        garch_beta=0.75, event_start_hour=1, n_pumps=0),
}


def _pair(name: str):
    kw = CONFIGS[name]
    return ref.MarketSimConfig(**kw), port.MarketSimConfig(**kw)


def test_config_defaults_equal():
    assert ref.MarketSimConfig() == ref.MarketSimConfig(**vars(port.MarketSimConfig()))


@pytest.mark.parametrize("shape", [(40,), (30, 1), (25, 7)])
def test_garch_path_bit_equal(shape):
    innov = np.random.default_rng(1).standard_t(4.0, size=shape)
    a = ref._garch_path(innov, 0.002, 0.12, 0.85)
    b = port._garch_path(innov, 0.002, 0.12, 0.85)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_simulate_market_bit_equal(name):
    rc, pc = _pair(name)
    a, b = ref.simulate_market(rc), port.simulate_market(pc)
    assert sorted(a) == sorted(b) == ["close", "high", "low", "open", "trades", "volume"]
    for key in a:
        assert a[key].shape == (rc.hours * 12, rc.n_symbols)
        assert a[key].dtype == b[key].dtype
        assert np.array_equal(a[key].view(np.int64), b[key].view(np.int64)), key


@pytest.mark.parametrize("name", ["small", "one_symbol"])
def test_write_market_file_bytes_equal(name, tmp_path):
    rc, pc = _pair(name)
    ra = ref.write_market_file(tmp_path / "ref.jsonl", rc)
    pa = port.write_market_file(tmp_path / "port.jsonl", pc)
    data = (tmp_path / "port.jsonl").read_bytes()
    assert data == (tmp_path / "ref.jsonl").read_bytes()
    assert data.count(b"\n") == (rc.hours * 12 // 3) * rc.n_symbols * 4
    assert all(np.array_equal(ra[k], pa[k]) for k in ra)


def test_write_market_file_gzip_content_equal(tmp_path):
    rc, pc = _pair("events_early")
    ref.write_market_file(tmp_path / "ref.jsonl.gz", rc)
    port.write_market_file(tmp_path / "port.jsonl.gz", pc)
    # the gzip header carries the write time: compare what it holds
    a = gzip.decompress((tmp_path / "ref.jsonl.gz").read_bytes())
    b = gzip.decompress((tmp_path / "port.jsonl.gz").read_bytes())
    assert a == b and len(a) > 0


def test_write_market_file_refuses_unaligned_start(tmp_path):
    with pytest.raises(AssertionError, match="15m-aligned"):
        port.write_market_file(tmp_path / "x.jsonl", port.MarketSimConfig(n_symbols=2, hours=1),
                               t0=1_753_000_201)
