# -*- coding: utf-8 -*-
"""The port's zstd decoder and CRC32C (``native/zstd_decode.cpp``,
``native.zstd_decompress`` / ``native.crc32c``) against the ``zstandard``
package, which serves only as the oracle here: several levels, data that
is random, zeros, repetitive, text-like and float-like, sizes from 0
bytes to 8 MB, with and without the checksum and the content size,
frames written whole and streamed, several frames in a row and skippable
frames.  Corrupt and truncated frames and bad CRC32C trailers raise."""

import struct
import zlib

import numpy as np
import pytest
import zstandard

from gaussiancity_tpu_torch import native
from gaussiancity_tpu_torch.testing import share_cpu_cores
from gaussiancity_tpu_torch.training import ocdbt

share_cpu_cores()


def _data(kind: str, size: int) -> bytes:
    rng = np.random.default_rng(size + len(kind))
    if kind == "random":
        return rng.integers(0, 256, size, np.uint8).tobytes()
    if kind == "zeros":
        return bytes(size)
    if kind == "repetitive":
        unit = rng.integers(0, 256, 37, np.uint8).tobytes()
        return (unit * (size // 37 + 1))[:size]
    if kind == "text":
        words = [b"gaussian", b"city", b"ocdbt", b"zarr", b"frame ", b"\n"]
        picks = rng.integers(0, len(words), size // 4 + 1)
        return b"".join(words[i] for i in picks)[:size]
    # float-like: a smooth field with noise, as weights and moments are
    n = size // 4 + 1
    x = (np.cumsum(rng.normal(size=n)) * 1e-3
         + rng.normal(size=n) * 1e-5).astype(np.float32)
    return x.tobytes()[:size]


KINDS = ("random", "zeros", "repetitive", "text", "floats")
SIZES = (0, 1, 7, 1000, 131_072, 300_001)


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", KINDS)
def test_decoder_matches_zstandard(level, kind):
    for size in SIZES:
        data = _data(kind, size)
        for checksum in (False, True):
            for content_size in (False, True):
                c = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum,
                    write_content_size=content_size).compress(data)
                got = native.zstd_decompress(c)
                assert got.tobytes() == data, (size, checksum,
                                               content_size)
                # into a buffer of the size the caller declares
                out = np.empty(len(data), np.uint8)
                assert native.zstd_decompress(c, out=out) is out
                assert out.tobytes() == data


@pytest.mark.parametrize("kind", KINDS)
def test_large_and_streamed_frames(kind):
    """8 MB at levels 1 and 3, written whole and streamed in pieces (no
    content size, many blocks), and as floats into a float32 buffer."""
    data = _data(kind, 8 << 20)
    for level in (1, 3):
        c = zstandard.ZstdCompressor(level=level).compress(data)
        assert native.zstd_decompress(c).tobytes() == data
        cobj = zstandard.ZstdCompressor(level=level,
                                        write_checksum=True).compressobj()
        streamed = b"".join(cobj.compress(data[i:i + 100_000])
                            for i in range(0, len(data), 100_000))
        streamed += cobj.flush()
        assert native.zstd_decompress(streamed).tobytes() == data
    if kind == "floats":
        want = np.frombuffer(data, np.float32)
        out = np.empty_like(want)
        native.zstd_decompress(zstandard.ZstdCompressor(level=1).compress(
            data), out=out)
        assert np.array_equal(out, want)


def test_several_frames_and_skippable_frames():
    parts = [_data(k, s) for k, s in (("text", 5000), ("zeros", 70_000),
                                      ("floats", 12_345), ("random", 0))]
    frames = [zstandard.ZstdCompressor(level=lvl).compress(p)
              for lvl, p in zip((1, 3, 19, 1), parts)]
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    stream = frames[0] + skip + frames[1] + frames[2] + skip + frames[3]
    assert native.zstd_decompress(stream).tobytes() == b"".join(parts)
    assert native.zstd_decompress(skip + frames[0]).tobytes() == parts[0]


def _frames_under_test():
    data = _data("text", 200_000) + _data("floats", 100_000)
    return [zstandard.ZstdCompressor(level=lvl, write_checksum=True)
            .compress(data) for lvl in (1, 19)], data


def test_corrupt_and_truncated_input_raises():
    """Every truncation raises; a flipped bit in a checksummed frame
    raises (the structure or the XXH64 checksum catches it) and never
    returns a partial buffer; a declared size the stream does not fill
    raises."""
    frames, data = _frames_under_test()
    rng = np.random.default_rng(0)
    for c in frames:
        for cut in sorted(set(rng.integers(0, len(c), 60).tolist())
                          | {0, 1, 4, 5, len(c) - 1}):
            with pytest.raises(ValueError, match="zstd"):
                native.zstd_decompress(c[:cut])
        for pos in rng.integers(0, len(c), 150):
            bad = bytearray(c)
            bad[pos] ^= 1 << int(rng.integers(0, 8))
            with pytest.raises(ValueError, match="at byte"):
                native.zstd_decompress(bytes(bad))
        with pytest.raises(ValueError, match="declared"):
            native.zstd_decompress(c, out=np.empty(len(data) + 1,
                                                   np.uint8))
        with pytest.raises(ValueError, match="larger than the buffer"):
            native.zstd_decompress(c, out=np.empty(len(data) - 1,
                                                   np.uint8))
    with pytest.raises(ValueError, match="magic"):
        native.zstd_decompress(b"\x00" * 16)
    with pytest.raises(ValueError, match="empty"):
        native.zstd_decompress(b"")
    # a dictionary frame is refused by name
    d = zstandard.train_dictionary(1024, [_data("text", 3000 + i)
                                          for i in range(200)])
    c = zstandard.ZstdCompressor(dict_data=d).compress(_data("text", 900))
    with pytest.raises(ValueError, match="dictionary"):
        native.zstd_decompress(c)


def test_crc32c():
    assert native.crc32c(b"123456789") == 0xE3069283
    assert native.crc32c(b"") == 0
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, 100_003, np.uint8).tobytes()
    # the bitwise definition, on a prefix (slow in Python)
    crc = 0xFFFFFFFF
    for b in data[:2000]:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 & -(crc & 1))
    assert native.crc32c(data[:2000]) == crc ^ 0xFFFFFFFF
    assert native.crc32c(data) != zlib.crc32(data)  # not the zlib CRC
    assert native.crc32c(np.frombuffer(data, np.uint8)) == \
        native.crc32c(data)


def test_ocdbt_frame_trailer_checked():
    """An OCDBT frame with a bad CRC32C trailer, a wrong length or a
    wrong magic raises; a good one decodes."""
    body = b"some node body" * 20
    comp = zstandard.ZstdCompressor(level=1).compress(body)
    head = struct.pack(">I", ocdbt.BTREE_MAGIC)
    n = 4 + 8 + 2 + len(comp) + 4
    frame = head + struct.pack("<Q", n) + b"\x00\x01" + comp
    good = frame + struct.pack("<I", native.crc32c(frame))
    assert ocdbt.decode_frame(good, ocdbt.BTREE_MAGIC, "node") == body
    bad = bytearray(good)
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="CRC32C"):
        ocdbt.decode_frame(bytes(bad), ocdbt.BTREE_MAGIC, "node")
    bad = bytearray(good)
    bad[30] ^= 4
    with pytest.raises(ValueError, match="CRC32C"):
        ocdbt.decode_frame(bytes(bad), ocdbt.BTREE_MAGIC, "node")
    with pytest.raises(ValueError, match="magic"):
        ocdbt.decode_frame(good, ocdbt.MANIFEST_MAGIC, "manifest")
    with pytest.raises(ValueError, match="header says"):
        ocdbt.decode_frame(good[:-5] + good[-4:], ocdbt.BTREE_MAGIC, "node")
