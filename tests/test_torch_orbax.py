# -*- coding: utf-8 -*-
"""The port's reader of the JAX package's Orbax checkpoints
(``training/ocdbt.py``, ``training/orbax_reader.py``) against the JAX
package's ``restore_checkpoint`` and TensorStore's ``ocdbt`` driver, on
the committed fixtures and on checkpoints written here; the legacy hash
table, a PTv3 checkpoint without running statistics and the directories
the reader refuses.

The fixtures ``tests/data/orbax_rest`` and ``tests/data/orbax_bldg`` are
written by the JAX package's own ``save_checkpoint`` from the tiny REST
and BLDG ``Trainer`` configs after two train steps (VGG zeroed so that it
compresses to nothing; G and D random), with ``digests.json`` of every
leaf as the JAX ``restore_checkpoint`` reads it.  Rewrite them with

    python tests/test_torch_orbax.py --write-fixtures
"""

import hashlib
import json
import os
import shutil
import struct
import sys
from pathlib import Path

if __name__ == "__main__":
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("GAUSSIANCITY_ALLOW_RANDOM_VGG", "1")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from gaussiancity_tpu.config import Config as JConfig
from gaussiancity_tpu.config import PTv3Config as JPTv3Config
from gaussiancity_tpu.ops import hash_grid as jhash_grid
from gaussiancity_tpu.training import checkpoint as jckpt
from gaussiancity_tpu.training.step import Trainer as JTrainer

from gaussiancity_tpu_torch import native
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.inference import loader
from gaussiancity_tpu_torch.ops import hash_grid
from gaussiancity_tpu_torch.testing import (TINY_PTV3, share_cpu_cores,
                                            tiny_bldg_batch)
from gaussiancity_tpu_torch.training import checkpoint
from gaussiancity_tpu_torch.training import ocdbt
from gaussiancity_tpu_torch.training import orbax_reader
from gaussiancity_tpu_torch.training.step import Trainer
from test_train_step import synthetic_batch, tiny_config

share_cpu_cores()

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = {"rest": DATA / "orbax_rest", "bldg": DATA / "orbax_bldg"}
FIXTURE_EPOCH = 1
FIXTURE_BYTES = 4 << 20  # both fixtures together


# ---------------------------------------------------------------------------
# the fixtures and their writer
# ---------------------------------------------------------------------------

def fixture_config(kind: str) -> JConfig:
    """The tiny REST (GLOBAL encoder, a 4-level hash grid of 2^10 rows) or
    BLDG (no encoder, sin/cos, z 16, the small PTv3) config of the train
    step tests, with a one-step D warm-up."""
    j = tiny_config(use_disc=True) if kind == "rest" else tiny_config(
        use_disc=True, z_dim=16, encoder=None)
    j = j.replace(train=j.train.replace(
        allow_random_vgg=True,
        discriminator=j.train.discriminator.replace(n_warmup_iters=1)))
    if kind == "bldg":
        j = j.replace(
            dataset=j.dataset.replace(
                test_crop_size=j.dataset.train_crop_size),
            network=j.network.replace(ptv3=JPTv3Config(**TINY_PTV3)))
    return j


def fixture_batch(kind: str, jcfg: JConfig) -> dict:
    """The batch of the fixture's train steps, as numpy arrays."""
    if kind == "rest":
        return {k: np.asarray(v) for k, v in
                synthetic_batch(jax.random.PRNGKey(1), jcfg).items()}
    return tiny_bldg_batch(Config.from_dict(jcfg.to_dict()))


def key_path(path) -> tuple:
    """A JAX key path as the strings Orbax names it by."""
    out = []
    for k in path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                out.append(str(getattr(k, attr)))
                break
        else:
            raise TypeError(k)
    return tuple(out)


def leaf_bytes(leaf) -> np.ndarray:
    """A leaf of either package as a numpy array whose bytes are its own
    (a bf16 torch tensor through uint16)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.view(torch.uint16).numpy() if \
            leaf.dtype == torch.bfloat16 else leaf.numpy()
    return np.asarray(leaf)


def dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return np.asarray(leaf).dtype.name


def digest(leaf) -> dict:
    a = leaf_bytes(leaf)
    return {"dtype": dtype_name(leaf), "shape": list(a.shape),
            "sha256": hashlib.sha256(
                np.ascontiguousarray(a).tobytes()).hexdigest()}


def jax_train(kind: str, n_steps: int = 2):
    """The JAX trainer of the fixture, its batch and its state after
    ``n_steps`` train steps (VGG zeroed before them)."""
    jcfg = fixture_config(kind)
    jt = JTrainer(jcfg)
    batch = {k: jnp.asarray(v) for k, v in fixture_batch(kind,
                                                          jcfg).items()}
    state = jt.init_state(jax.random.PRNGKey(0), batch)
    state = state.replace(ploss_params=jax.tree_util.tree_map(
        jnp.zeros_like, state.ploss_params))
    step = jax.jit(jt.train_step)
    for i in range(n_steps):
        state, _ = step(state, batch, jax.random.PRNGKey(10 + i))
    return jt, batch, state


def abstract_state(kind: str):
    """The shapes of the fixture's ``TrainState`` (traced, not run), the
    template ``restore_checkpoint`` takes."""
    jcfg = fixture_config(kind)
    jt = JTrainer(jcfg)
    batch = {k: jnp.asarray(v) for k, v in fixture_batch(kind,
                                                          jcfg).items()}
    return jax.eval_shape(jt.init_state, jax.random.PRNGKey(0), batch)


def jax_restore(directory, kind: str):
    """The JAX package's ``restore_checkpoint`` of a fixture directory ->
    (key path -> numpy leaf, config, epoch)."""
    state, cfg, epoch = jckpt.restore_checkpoint(str(directory),
                                                 abstract_state(kind))
    flat = jax.tree_util.tree_flatten_with_path(state)[0]
    return {key_path(p): np.asarray(v) for p, v in flat}, cfg, epoch


def write_fixtures() -> None:
    """Write both fixtures with the JAX package's ``save_checkpoint`` and
    their digests from its ``restore_checkpoint``."""
    for kind, directory in FIXTURES.items():
        _, _, state = jax_train(kind)
        shutil.rmtree(directory, ignore_errors=True)
        jckpt.save_checkpoint(str(directory), FIXTURE_EPOCH, state,
                              fixture_config(kind))
        leaves, _, _ = jax_restore(directory, kind)
        with open(directory / "digests.json", "w") as f:
            json.dump({"/".join(p): digest(v) for p, v in leaves.items()},
                      f, indent=1, sort_keys=True)
        size = sum(p.stat().st_size for p in directory.rglob("*")
                   if p.is_file())
        print(f"{directory}: {len(leaves)} leaves, {size} bytes")


# ---------------------------------------------------------------------------
# zstd blocks of a store's values (to show which parts of the format the
# fixtures use)
# ---------------------------------------------------------------------------

def zstd_block_kinds(frame: bytes) -> list:
    """(block type, literals type, sequence modes) of each block of the
    zstd frames in ``frame``: block types raw / rle / compressed, literals
    raw / rle / huffman / treeless, sequence modes (LL, OF, ML) each
    predefined / rle / fse / repeat, or None without sequences."""
    names = ("raw", "rle", "compressed", "reserved")
    lits = ("raw", "rle", "huffman", "treeless")
    modes = ("predefined", "rle", "fse", "repeat")
    out, p = [], 0
    while p < len(frame):
        (magic,) = struct.unpack_from("<I", frame, p)
        assert magic == 0xFD2FB528, hex(magic)
        fhd = frame[p + 4]
        single = (fhd >> 5) & 1
        fcs = {0: 1 if single else 0, 1: 2, 2: 4, 3: 8}[fhd >> 6]
        p += 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] + fcs
        while True:
            bh = int.from_bytes(frame[p:p + 3], "little")
            p += 3
            btype, size = (bh >> 1) & 3, bh >> 3
            if btype != 2:
                out.append((names[btype], None, None))
            else:
                b = frame[p:p + size]
                lt, sf = b[0] & 3, (b[0] >> 2) & 3
                if lt <= 1:
                    hs = (1, 2, 1, 3)[sf]
                    regen = (b[0] >> 3 if sf in (0, 2) else
                             (b[0] >> 4) + (b[1] << 4) if sf == 1 else
                             (b[0] >> 4) + (b[1] << 4) + (b[2] << 12))
                    q = hs + (regen if lt == 0 else 1)
                else:
                    hs, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[sf]
                    h = int.from_bytes(b[:hs], "little")
                    q = hs + ((h >> (4 + bits)) & ((1 << bits) - 1))
                nseq = b[q]
                mode = None
                if nseq:
                    q += 1 if nseq < 128 else 2 if nseq < 255 else 3
                    m = b[q]
                    mode = (modes[m >> 6], modes[(m >> 4) & 3],
                            modes[(m >> 2) & 3])
                out.append(("compressed", lits[lt], mode))
            p += 1 if btype == 1 else size
            if bh & 1:
                break
        if (fhd >> 2) & 1:
            p += 4
    return out


# ---------------------------------------------------------------------------
# the fixtures
# ---------------------------------------------------------------------------

def test_fixtures_are_small_and_complete():
    size = sum(p.stat().st_size for d in FIXTURES.values()
               for p in d.rglob("*") if p.is_file())
    assert size <= FIXTURE_BYTES, size
    for kind, directory in FIXTURES.items():
        assert orbax_reader.checkpoint_steps(str(directory)) == \
            [FIXTURE_EPOCH]
        ck = orbax_reader.OrbaxCheckpoint(str(directory))
        assert ck.epoch == FIXTURE_EPOCH
        assert ck.config == Config.from_dict(fixture_config(kind).to_dict())
        state = ck.tree()
        assert int(state["step"]) == 2
        assert int(state["g_opt"][0]["count"]) == 2
        assert int(state["d_opt"][0]["count"]) == 2
        assert int(state["d_opt"][1]["count"]) == 2
        assert state["g_opt"][1] is None
        mu = [np.abs(v).max() for v in
              jax.tree_util.tree_leaves(state["g_opt"][0]["mu"])]
        assert min(mu) >= 0 and max(mu) > 0
        assert (kind == "bldg") == bool(state["g_stats"])
        assert all(not np.any(v) for v in
                   jax.tree_util.tree_leaves(state["ploss_params"]))


@pytest.mark.parametrize("kind", ["rest", "bldg"])
def test_fixture_read_equals_jax_restore(kind):
    """Every leaf bit-equal to the JAX ``restore_checkpoint`` of the same
    directory, and to the committed digests; the config and epoch too."""
    directory = FIXTURES[kind]
    want, jcfg, jepoch = jax_restore(directory, kind)
    ck = orbax_reader.OrbaxCheckpoint(str(directory))
    got = ck.read()
    arrays = {p: v for p, v in got.items() if v is not None
              and not isinstance(v, (dict, tuple, list))}
    assert set(arrays) == set(want)
    for path, w in want.items():
        g = leaf_bytes(arrays[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path
    assert ck.config == Config.from_dict(jcfg.to_dict())
    assert ck.epoch == jepoch
    with open(directory / "digests.json") as f:
        digests = json.load(f)
    assert digests == {"/".join(p): digest(v) for p, v in arrays.items()}
    # names with '/' inside a key (spectral norm) are rebuilt, not split
    assert ("d_stats", "enc1", "SpectralNorm_0", "Conv_0/kernel/u") in \
        arrays
    assert ck.decoded_bytes == sum(leaf_bytes(v).nbytes
                                   for v in arrays.values())


@pytest.mark.parametrize("kind", ["rest", "bldg"])
def test_fixture_store_equals_tensorstore(kind):
    state = str(FIXTURES[kind] / str(FIXTURE_EPOCH) / "state")
    _assert_store_equal(state)


def _assert_store_equal(path: str) -> int:
    store = ocdbt.OcdbtStore(path)
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": "file://" + os.path.abspath(path)}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.list() == keys
    for k in keys:
        assert bytes(store.read(k)) == kv.read(k).result().value, k
    return len(keys)


def test_fixtures_use_huffman_literals_and_fse_sequences():
    """At least one array's chunk has compressed blocks with Huffman
    literals and FSE-compressed sequence tables: the fixtures exercise the
    decoder well beyond raw blocks."""
    seen = set()
    for directory in FIXTURES.values():
        store = ocdbt.OcdbtStore(str(directory / str(FIXTURE_EPOCH)
                                     / "state"))
        for key in store.list():
            if key.endswith(".zarray"):
                continue
            for block in zstd_block_kinds(bytes(store.read(key))):
                seen.add((block[0], block[1],
                          "fse" in (block[2] or ())))
    assert ("compressed", "huffman", True) in seen, seen


# ---------------------------------------------------------------------------
# checkpoints written here
# ---------------------------------------------------------------------------

def _save_tree(directory, tree, cfg: JConfig, epoch: int = 0) -> None:
    jckpt.save_checkpoint(str(directory), epoch, tree, cfg)


def test_fresh_checkpoint_dtypes_and_structure(tmp_path):
    """A tree of every dtype the reader names, nested dicts, tuples,
    lists, None and empty containers, a key with '/' inside: read
    bit-equal to the values saved and to Orbax's restore, with its
    structure; and the store equal to TensorStore's."""
    import ml_dtypes
    import orbax.checkpoint as ocp

    rng = np.random.default_rng(3)
    tree = {
        "f32": rng.normal(size=(3, 5)).astype(np.float32),
        "f16": rng.normal(size=(7,)).astype(np.float16),
        "bf16": rng.normal(size=(4, 6)).astype(ml_dtypes.bfloat16),
        "jbf16": jnp.asarray(rng.normal(size=(9,)), jnp.bfloat16),
        "i32": rng.integers(-9, 9, (2, 3, 4)).astype(np.int32),
        "i64": rng.integers(-2 ** 40, 2 ** 40, (5,)).astype(np.int64),
        "u32": rng.integers(0, 2 ** 32, (6,), dtype=np.uint64).astype(
            np.uint32),
        "b1": rng.random((3, 3)) > 0.5,
        "u8": rng.integers(0, 256, (10,)).astype(np.uint8),
        "scalar": np.float32(2.5),
        "nested": {"Conv_0/kernel/u": rng.normal(size=(1, 8)).astype(
            np.float32), "tup": (np.arange(3, dtype=np.int32),
                                 {"deep": np.ones((2, 2), np.float32)})},
        "lst": [np.zeros(2, np.float32), np.full(3, 7, np.int32)],
        "none": None,
        "empty": {},
    }
    _save_tree(tmp_path / "ck", tree, fixture_config("rest"), epoch=5)
    ck = orbax_reader.OrbaxCheckpoint(str(tmp_path / "ck"))
    assert ck.step == 5 and ck.epoch == 5
    got = ck.tree()
    mngr = ocp.CheckpointManager(str(tmp_path / "ck"))
    restored = mngr.restore(5, args=ocp.args.Composite(
        state=ocp.args.StandardRestore()))["state"]
    mngr.close()
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    for path, value in flat:
        keys = key_path(path)
        mine = got
        for k in keys:
            mine = mine[int(k)] if isinstance(mine, tuple) else mine[k]
        want = np.asarray(value)
        theirs = np.asarray(_dig(restored, keys))
        if want.dtype == ml_dtypes.bfloat16:
            assert mine.dtype == torch.bfloat16
            assert np.array_equal(leaf_bytes(mine), want.view(np.uint16))
            assert np.array_equal(leaf_bytes(mine), theirs.view(np.uint16))
            continue
        mine = leaf_bytes(mine)
        assert mine.dtype == want.dtype and mine.shape == want.shape, keys
        assert mine.tobytes() == want.tobytes() == theirs.tobytes(), keys
    assert isinstance(got["nested"]["tup"], tuple)
    assert isinstance(got["lst"], tuple) and len(got["lst"]) == 2
    assert got["none"] is None and got["empty"] == {}
    _assert_store_equal(str(tmp_path / "ck" / "5" / "state"))


def _dig(tree, keys):
    for k in keys:
        tree = tree[int(k)] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def test_fresh_train_state_and_full_width_hash_table(tmp_path):
    """A train state saved here after one JAX step, plus one leaf at the
    REST recipe's full width ([16, 2^19, 8] float32): the port's read of
    every leaf bit-equal to the JAX restore, and the OCDBT store equal to
    TensorStore's."""
    import orbax.checkpoint as ocp

    _, _, state = jax_train("rest", n_steps=1)
    table = np.random.default_rng(0).normal(
        size=(16, 1 << 19, 8)).astype(np.float32)
    _save_tree(tmp_path / "ck", {"state": state, "table": table},
               fixture_config("rest"))
    mngr = ocp.CheckpointManager(str(tmp_path / "ck"))
    restored = mngr.restore(0, args=ocp.args.Composite(
        state=ocp.args.StandardRestore()))["state"]
    mngr.close()
    got = orbax_reader.OrbaxCheckpoint(str(tmp_path / "ck")).read()
    flat = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(flat) == len([v for v in got.values() if v is not None
                             and not isinstance(v, (dict, tuple, list))])
    for path, want in flat:
        mine = leaf_bytes(got[key_path(path)])
        want = np.asarray(want)
        assert mine.dtype == want.dtype and mine.shape == want.shape
        assert mine.tobytes() == want.tobytes(), key_path(path)
    assert np.array_equal(got[("table",)], table)
    del got, restored, flat
    n = _assert_store_equal(str(tmp_path / "ck" / "0" / "state"))
    assert n > 100


def test_zarr_chunk_grids_orders_and_missing_chunks(tmp_path):
    """Zarr v2 arrays that TensorStore writes into an OCDBT store: several
    chunks per array with partial edge chunks, C and F order, zstd and no
    compressor, chunks never written (the fill value, zeros where it is
    null), bfloat16."""
    path = str(tmp_path / "kv")
    base = {"driver": "ocdbt", "base": "file://" + path}
    rng = np.random.default_rng(1)
    cases = []
    for i, (shape, chunks, order, comp, dtype, fill) in enumerate([
            ((10, 7), (4, 3), "C", {"id": "zstd", "level": 3}, "<f4", None),
            ((10, 7), (4, 3), "F", {"id": "zstd", "level": 1}, "<i4", 5),
            ((5, 6, 3), (2, 6, 2), "F", None, "<f2", None),
            ((33,), (8,), "C", None, "|u1", 9),
            ((6, 4), (4, 4), "C", {"id": "zstd", "level": 1}, "bfloat16",
             None)]):
        name = f"a{i}"
        arr = ts.open({"driver": "zarr", "kvstore": base, "path": name,
                       "metadata": {"shape": list(shape),
                                    "chunks": list(chunks), "order": order,
                                    "compressor": comp, "dtype": dtype,
                                    "fill_value": fill}},
                      create=True).result()
        data = (rng.normal(size=shape) * 50).astype(arr.dtype.numpy_dtype)
        # leave the first chunk of each array unwritten
        region = tuple(slice(c, None) if j == 0 else slice(None)
                       for j, c in enumerate(chunks))
        arr[region] = data[region]
        want = data.copy()
        want[tuple(slice(0, c) if j == 0 else slice(None)
                   for j, c in enumerate(chunks))] = 0
        head = tuple(slice(0, c) for c in chunks)
        if fill is not None:
            want[tuple(slice(0, c) for c in chunks[:1])] = 0
            want[head] = fill
        else:
            want[head] = 0
        cases.append((name, arr.read().result(), dtype))
    store = ocdbt.OcdbtStore(path)
    for name, want, dtype in cases:
        z = orbax_reader.ZarrArray(store, name)
        got = z.read()
        want = np.asarray(want)
        if dtype == "bfloat16":
            assert z.bf16
            want = want.view(np.uint16)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert got.tobytes() == want.tobytes(), name


# ---------------------------------------------------------------------------
# refusals and the legacy table
# ---------------------------------------------------------------------------

def test_repack_legacy_table_matches_jax():
    args = (3, 4, 16, 256, 10)
    _, offsets, _, _, total = jhash_grid.level_params(*args)
    packed = np.random.default_rng(0).normal(size=(total, 2)).astype(
        np.float32)
    got = hash_grid.repack_legacy_table(packed, *args)
    np.testing.assert_array_equal(got, jhash_grid.repack_legacy_table(
        packed, *args))
    with pytest.raises(ValueError, match="not a legacy"):
        hash_grid.repack_legacy_table(packed[:-8], *args)


def _legacy_state(tmp_path):
    """The REST fixture's state with its hash table (and the table's Adam
    moments) packed as a round-1 [total_rows, C] array."""
    ck = orbax_reader.OrbaxCheckpoint(str(FIXTURES["rest"]))
    state = ck.tree()
    enc = Trainer(ck.config, device="cpu").generator.pos_encoder
    _, offsets, _, _, total = hash_grid.level_params(
        enc.in_channels, enc.n_levels, enc.base_resolution,
        enc.desired_resolution, enc.log2_hashmap_size)

    def pack(table):
        rows = [(list(offsets) + [total])[i + 1] - offsets[i]
                for i in range(len(offsets))]
        return np.concatenate([table[i, :r] for i, r in enumerate(rows)])

    state["g_params"]["pos_encoder"]["embeddings"] = pack(
        state["g_params"]["pos_encoder"]["embeddings"])
    for key in ("mu", "nu"):
        enc = state["g_opt"][0][key]["pos_encoder"]
        enc["embeddings"] = pack(enc["embeddings"])
    state["g_opt"] = (dict(state["g_opt"][0]), None)
    d = tmp_path / "legacy"
    _save_tree(d, state, fixture_config("rest"), epoch=FIXTURE_EPOCH)
    return d


def test_legacy_hash_table_raises_before_any_load(tmp_path):
    d = _legacy_state(tmp_path)
    t = Trainer(Config.from_dict(fixture_config("rest").to_dict()),
                device="cpu")
    before = {k: v.clone() for k, v in t.generator.state_dict().items()}
    with pytest.raises(ValueError, match="repack_legacy_table"):
        checkpoint.restore_checkpoint(str(d), t)
    after = t.generator.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert t.step == 0 and not t.g_opt.state
    with pytest.raises(ValueError, match="gaussiancity_tpu_torch.ops."
                                         "hash_grid.repack_legacy_table"):
        loader.load_generator(str(d), device="cpu")


def test_ptv3_checkpoint_without_running_stats_raises(tmp_path):
    ck = orbax_reader.OrbaxCheckpoint(str(FIXTURES["bldg"]))
    state = ck.tree(orbax_reader.under("g_params"))
    _save_tree(tmp_path / "nostats", state, fixture_config("bldg"))
    with pytest.raises(ValueError, match="g_stats"):
        loader.load_generator(str(tmp_path / "nostats"), device="cpu")
    # with them it loads, in eval mode, on the CPU as asked
    cfg, gen, z_bank = loader.load_generator(str(FIXTURES["bldg"]),
                                             device="cpu")
    assert not gen.training and z_bank is None
    assert cfg.network.ptv3.enabled
    assert next(gen.parameters()).device.type == "cpu"


def test_directories_the_reader_refuses(tmp_path):
    t = Trainer(Config.from_dict(fixture_config("rest").to_dict()),
                device="cpu")
    # a step still being written only
    tmp_only = tmp_path / "tmp_only"
    (tmp_only / "3.orbax-checkpoint-tmp-1234").mkdir(parents=True)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(str(tmp_only), t)
    with pytest.raises(FileNotFoundError):
        loader.load_generator(str(tmp_only), device="cpu")
    assert orbax_reader.checkpoint_steps(str(tmp_only)) == []
    # both kinds in one directory
    mixed = tmp_path / "mixed"
    shutil.copytree(FIXTURES["rest"], mixed)
    checkpoint.save_epoch(str(mixed), 4, t)
    with pytest.raises(ValueError, match="both"):
        checkpoint.restore_checkpoint(str(mixed), t)
    with pytest.raises(ValueError, match="both"):
        checkpoint.latest_epoch(str(mixed))
    # a tmp step beside a finished one is ignored
    ok = tmp_path / "ok"
    shutil.copytree(FIXTURES["rest"], ok)
    (ok / "7.orbax-checkpoint-tmp-99").mkdir()
    assert checkpoint.latest_epoch(str(ok)) == FIXTURE_EPOCH
    # a corrupt node fails its CRC32C
    bad = tmp_path / "bad"
    shutil.copytree(FIXTURES["rest"], bad)
    manifest = bad / str(FIXTURE_EPOCH) / "state" / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 0x40
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC32C"):
        orbax_reader.OrbaxCheckpoint(str(bad))


def _frame(magic: int, body: bytes) -> bytes:
    """An uncompressed OCDBT file: magic, length, version 0, compression
    0, the body and its CRC32C."""
    head = struct.pack(">I", magic) + struct.pack(
        "<Q", 4 + 8 + 2 + len(body) + 4) + b"\x00\x00"
    return head + body + struct.pack("<I", native.crc32c(head + body))


@pytest.mark.parametrize("outside", ["../", "/"])
def test_data_file_paths_outside_the_store_raise(tmp_path, outside):
    """A manifest whose data-file table names a file outside the store's
    directory (``..`` or an absolute path) is refused before any read."""
    state = tmp_path / "ck" / str(FIXTURE_EPOCH) / "state"
    shutil.copytree(FIXTURES["rest"], tmp_path / "ck")
    manifest = state / "manifest.ocdbt"
    body = ocdbt.decode_frame(manifest.read_bytes(), ocdbt.MANIFEST_MAGIC,
                              "manifest")
    (name,) = os.listdir(state / "d")
    rel = f"d/{name}".encode()
    assert body.count(rel) == 1
    # the body framed anew reads as before
    manifest.write_bytes(_frame(ocdbt.MANIFEST_MAGIC, body))
    assert ocdbt.OcdbtStore(str(state)).list()
    # the same length, so that the table's varints stay as they are
    forged = (outside + "x" * len(rel)).encode()[:len(rel)]
    manifest.write_bytes(_frame(ocdbt.MANIFEST_MAGIC,
                                body.replace(rel, forged)))
    with pytest.raises(ValueError, match="outside the store"):
        ocdbt.OcdbtStore(str(state))
    with pytest.raises(ValueError, match="outside the store"):
        orbax_reader.OrbaxCheckpoint(str(tmp_path / "ck")).read()


def test_loader_decodes_only_the_generator():
    """``load_generator`` of an Orbax directory decodes the generator's
    leaves alone: no VGG, discriminator or moments for a frame."""
    seen = []
    real = orbax_reader.ZarrArray.read

    def recording(self):
        seen.append(self.name)
        return real(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(orbax_reader.ZarrArray, "read", recording)
    try:
        loader.load_generator(str(FIXTURES["rest"]), device="cpu")
    finally:
        mp.undo()
    assert seen and all(n.split(".")[0] in loader.GENERATOR_ITEMS
                        for n in seen), seen
    assert any(n.startswith("g_params.pos_encoder") for n in seen)


def test_native_decoder_links_no_zstd_library():
    """The decoder is the repository's own: its library needs no libzstd
    and the port's modules import no JAX, Orbax, TensorStore or
    zstandard."""
    import subprocess

    native._zstd()
    lib = os.path.join(os.path.dirname(native.__file__), "_build",
                       "libgct_zstd.so")
    out = subprocess.run(["ldd", lib], capture_output=True, text=True)
    assert "zstd" not in out.stdout
    pkg = Path(native.__file__).resolve().parents[1]
    for mod in ("native/__init__.py", "training/ocdbt.py",
                "training/orbax_reader.py", "training/checkpoint.py",
                "inference/loader.py", "interop.py"):
        text = (pkg / mod).read_text()
        for name in ("import jax", "orbax.checkpoint", "import tensorstore",
                     "import zstandard", "libzstd", "gaussiancity_tpu."):
            assert name not in text, (mod, name)


if __name__ == "__main__":
    if "--write-fixtures" in sys.argv[1:]:
        write_fixtures()
    else:
        sys.exit(pytest.main([__file__, "-q"]))
