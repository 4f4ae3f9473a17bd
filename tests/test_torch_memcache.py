# -*- coding: utf-8 -*-
"""The port's memcached client (``gaussiancity_tpu_torch/data/
memcache.py``) against the JAX package's, on the JAX suite's in-process
``socketserver`` fake: the same keys, chunks and meta entries on the
server for the same files (so that either package reads what the other
wrote), misses on a partial eviction or a dead server, and the port's
``IO`` and ``get_dataset`` with the client installed."""

import os
import pickle

import numpy as np
import pytest

from gaussiancity_tpu.data import memcache as jmemcache

from gaussiancity_tpu_torch.config import Config, MemcachedConfig
from gaussiancity_tpu_torch.data import memcache
from gaussiancity_tpu_torch.data.datasets import get_dataset
from gaussiancity_tpu_torch.data.io import IO
from gaussiancity_tpu_torch.data.memcache import MemcachedClient
from gaussiancity_tpu_torch.testing import share_cpu_cores

from test_memcache import fake_server  # noqa: F401  (fixture)

share_cpu_cores()


def _address(srv):
    return f"127.0.0.1:{srv.server_address[1]}"


@pytest.mark.parametrize("size", [0, 1000, 10 * 1024 + 17])
def test_store_matches_jax_client(fake_server, monkeypatch,  # noqa: F811
                                  size):
    """The port writes the entries the JAX client writes (1 KB chunks:
    11 for the largest file), and each reads the other's."""
    monkeypatch.setattr(memcache, "_CHUNK", 1024)
    monkeypatch.setattr(jmemcache, "_CHUNK", 1024)
    blob = np.random.default_rng(size).bytes(size)
    port = MemcachedClient([_address(fake_server)])
    jax_client = jmemcache.MemcachedClient([_address(fake_server)])
    assert port.set_file("/a/file.pkl", blob)
    written = dict(fake_server.store)
    fake_server.store.clear()
    assert jax_client.set_file("/a/file.pkl", blob)
    assert fake_server.store == written
    assert port.get_file("/a/file.pkl") == blob
    assert port.get_file("/other.pkl") is None
    assert MemcachedClient._key("/x") == jmemcache.MemcachedClient._key("/x")


def test_misses(fake_server, monkeypatch):  # noqa: F811
    monkeypatch.setattr(memcache, "_CHUNK", 1024)
    c = MemcachedClient([_address(fake_server)])
    assert c.set_file("/evict.npy", os.urandom(3000))
    victim = next(k for k in fake_server.store if k.endswith(b":1"))
    del fake_server.store[victim]
    assert c.get_file("/evict.npy") is None
    dead = MemcachedClient(["127.0.0.1:1"], timeout=0.2)
    assert dead.get_file("/x") is None and not dead.set_file("/x", b"d")
    with pytest.raises(ValueError):
        MemcachedClient([])


class TestIO:
    @pytest.fixture(autouse=True)
    def _clean_cache(self):
        yield
        IO.configure_cache(None)

    def test_populate_on_miss_then_serve_from_cache(
            self, fake_server, tmp_path):  # noqa: F811
        IO.configure_cache(MemcachedClient([_address(fake_server)]))
        arr = np.arange(24, dtype=np.float32).reshape(4, 6)
        obj = {"pts": np.ones((3, 2), np.int16), "n": 7}
        pa, pp = str(tmp_path / "a.npy"), str(tmp_path / "b.pkl")
        np.save(pa, arr)
        with open(pp, "wb") as f:
            pickle.dump(obj, f)
        np.testing.assert_array_equal(IO.get(pa), arr)  # miss -> disk
        assert IO.get(pp)["n"] == 7
        os.remove(pa)
        os.remove(pp)
        np.testing.assert_array_equal(IO.get(pa), arr)  # from the cache
        assert IO.get(pp)["n"] == 7

    def test_get_dataset_installs_the_client(self, fake_server,  # noqa: F811
                                             tmp_path):
        cfg = Config(memcached=MemcachedConfig(
            enabled=True, servers=(_address(fake_server),)))
        cfg = cfg.replace(dataset=cfg.dataset.replace(dir=str(tmp_path)))
        get_dataset(cfg, "SYNTHETIC", "val")
        assert isinstance(IO._cache, MemcachedClient)
