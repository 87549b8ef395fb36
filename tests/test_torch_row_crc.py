"""The native row checksum (``core/row_crc.py`` over ``csrc/row_crc32.c``)
against ``zlib.crc32``, bit for bit: every row length 0-300 bytes and the
offload cell's 32,896-byte payload row (2 x 32 x 128 + 32 f32), at every
start offset 0-15, on random bytes and on f32 payloads with NaN, inf and
-0.0 bit patterns (rows under 64 bytes and every tail through the byte
table, the rest through the carry-less-multiply fold); the one-pass gather
against ``np.take(..., mode="clip")`` with only the flagged rows
checksummed; ``zlib`` on hosts that are not x86-64.
"""
import zlib

import numpy as np
import pytest

from repro_torch.core import row_crc

CELL_ROW = (2 * 32 * 128 + 32) * 4


@pytest.fixture
def crc():
    """The routine (every x86-64 host this runs on has PCLMULQDQ)."""
    lib = row_crc.native()
    assert lib is not None, "no native routine on this x86-64 host"
    return lib


def _zlib(rows):
    return np.array([zlib.crc32(r.tobytes()) for r in rows], np.uint32)


def _special_f32(rng, n, width):
    """f32 rows salted with NaNs (quiet, signalling, with payloads), infs,
    -0.0 and denormals."""
    a = rng.standard_normal((n, width)).astype(np.float32)
    bits = a.view(np.uint32)
    special = np.array([0x7FC00000, 0xFFC00001, 0x7F800001, 0x7FBFFFFF,
                        0x7F800000, 0xFF800000, 0x80000000, 0x00000001,
                        0x807FFFFF], np.uint32)
    at = rng.random((n, width)) < 0.2
    bits[at] = rng.choice(special, int(at.sum()))
    return a


def test_every_length_and_offset_against_zlib(crc):
    rng = np.random.default_rng(0)
    for length in range(301):
        for off in range(16):
            buf = rng.integers(0, 256, off + 3 * length, np.uint8)
            rows = buf[off:].reshape(3, length)
            np.testing.assert_array_equal(crc.rows(rows), _zlib(rows),
                                          err_msg=f"{length} @ {off}")


def test_cell_row_at_every_offset(crc):
    rng = np.random.default_rng(1)
    for off in range(16):
        buf = np.empty(off + 4 * CELL_ROW, np.uint8)
        rows = buf[off:].reshape(4, CELL_ROW)
        rows[:2] = rng.integers(0, 256, (2, CELL_ROW), np.uint8)
        rows[2:] = _special_f32(rng, 2, CELL_ROW // 4).view(np.uint8)
        np.testing.assert_array_equal(crc.rows(rows), _zlib(rows),
                                      err_msg=f"offset {off}")


def test_f32_payload_rows(crc):
    rng = np.random.default_rng(2)
    for width in (5, 16, 17, 64, 8224):
        rows = _special_f32(rng, 9, width)
        np.testing.assert_array_equal(crc.rows(rows), _zlib(rows))
    assert crc.rows(np.zeros((0, 5), np.float32)).shape == (0,)


@pytest.mark.parametrize("width", [5, 8224])
def test_gather_copies_like_take_and_checks_flagged_rows(crc, width):
    rng = np.random.default_rng(width)
    store = _special_f32(rng, 40, width)
    n = 64
    idx = rng.integers(-3, 44, n).astype(np.int64)     # some clipped
    check = rng.random(n) < 0.6
    out = np.full((n + 2, width), 7.0, np.float32)
    got = np.full(n, 0xDEADBEEF, np.uint32)
    crc.gather(store, idx, out, check, got)
    want = np.take(store, idx, axis=0, mode="clip")
    np.testing.assert_array_equal(out[:n].view(np.uint32),
                                  want.view(np.uint32))
    assert (out[n:] == 7.0).all()
    np.testing.assert_array_equal(got[check], _zlib(want[check]))
    assert (got[~check] == 0xDEADBEEF).all()


def test_gather_refuses_mismatched_arrays(crc):
    store = np.zeros((4, 5), np.float32)
    idx = np.zeros(3, np.int64)
    check = np.ones(3, bool)
    got = np.zeros(3, np.uint32)
    with pytest.raises(ValueError):
        crc.gather(store, idx, np.zeros((2, 5), np.float32), check, got)
    with pytest.raises(ValueError):
        crc.gather(store, idx.astype(np.int32), np.zeros((3, 5), np.float32),
                   check, got)
    with pytest.raises(ValueError):
        crc.gather(store, idx, np.zeros((3, 6), np.float32), check, got)
    with pytest.raises(ValueError):
        crc.rows(np.zeros((4, 6), np.float32)[:, :5])


def test_zlib_on_other_hosts(monkeypatch):
    """A host that is not x86-64 gets no routine (its wave buffers use
    zlib), and builds nothing for it."""
    row_crc.native.cache_clear()
    monkeypatch.setattr(row_crc.platform, "machine", lambda: "aarch64")
    monkeypatch.setattr(row_crc.build, "load", None)
    try:
        assert row_crc.native() is None
    finally:
        row_crc.native.cache_clear()
