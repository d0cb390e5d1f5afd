"""npy container contract tests: byte-identity vs the reference golden file."""

import numpy as np
import pytest

from msbwt_jax.ops.rle import convert_to_vec
from msbwt_jax.utils.npy import load_bwt_bytes, save_bwt_bytes, save_bwt_runs

from tests._data import GOLDEN_NPY as GOLDEN  # noqa: E402


def test_load_golden_two_string():
    body = load_bwt_bytes(GOLDEN)
    # verified hex of the golden body (SURVEY.md C12)
    assert body.tolist() == [0x0D, 0x09, 0x0A, 0x08, 0x0B, 0x09, 0x0D, 0x0A, 0x0B, 0x08]


def test_save_byte_identical_to_golden(tmp_path):
    body = load_bwt_bytes(GOLDEN)
    out = tmp_path / "out.npy"
    save_bwt_bytes(body, str(out))
    assert out.read_bytes() == open(GOLDEN, "rb").read()


def test_save_header_layout(tmp_path):
    # ref test: src/bwt_converter.rs:259-284
    vec = convert_to_vec("A" * (32 + 32 * 32 * 3))
    out = tmp_path / "t.npy"
    save_bwt_bytes(vec, str(out))
    raw = out.read_bytes()
    header = (
        b"\x93NUMPY\x01\x00\x56\x00"
        b"{'descr': '|u1', 'fortran_order': False, 'shape': (3, ), }"
    )
    expected = header + b" " * (95 - len(header)) + b"\n" + bytes([1, 9, 1 + (3 << 3)])
    assert raw == expected


def test_save_runs(tmp_path):
    # ref test: src/bwt_converter.rs:287-321
    out = tmp_path / "runs.npy"
    save_bwt_runs(
        np.array([1, 0], dtype=np.uint8),
        np.array([32 + 32 * 32 * 3, 1], dtype=np.uint64),
        str(out),
    )
    body = load_bwt_bytes(str(out))
    assert body.tolist() == [1, 9, 1 + (3 << 3), 0 + (1 << 3)]


def test_reader_checks_size(tmp_path):
    out = tmp_path / "bad.npy"
    save_bwt_bytes(np.array([1, 2, 3], dtype=np.uint8), str(out))
    raw = bytearray(out.read_bytes())
    raw.append(7)  # one extra body byte -> size mismatch
    out.write_bytes(bytes(raw))
    with pytest.raises(IOError):
        load_bwt_bytes(str(out))


def test_reader_numpy_compatible(tmp_path):
    # our writer's files load with numpy itself, and numpy's own files load with us
    out = tmp_path / "np.npy"
    data = np.arange(17, dtype=np.uint8)
    save_bwt_bytes(data, str(out))
    assert np.load(str(out)).tolist() == data.tolist()
    np.save(str(tmp_path / "np2.npy"), data)
    assert load_bwt_bytes(str(tmp_path / "np2.npy")).tolist() == data.tolist()
