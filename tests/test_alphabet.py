"""L0 alphabet tests (mirrors ref: src/string_util.rs:90-121)."""

import numpy as np

from msbwt_jax.ops.alphabet import (
    COMPLEMENT_INT,
    INT_TO_STRING,
    STRING_TO_INT,
    convert_itos,
    convert_stoi,
    reverse_complement_i,
)


def test_convert_stoi():
    assert convert_stoi("ACGTN$").tolist() == [1, 2, 3, 5, 4, 0]
    assert convert_stoi("acgtn").tolist() == [1, 2, 3, 5, 4]


def test_unknown_maps_to_n():
    # every other byte maps to N=4 (ref: src/string_util.rs:16)
    assert convert_stoi("XYZ*!").tolist() == [4, 4, 4, 4, 4]
    assert STRING_TO_INT[ord("q")] == 4


def test_convert_itos():
    assert convert_itos([0, 1, 2, 3, 4, 5]) == "$ACGNT"


def test_reverse_complement_i():
    seq = np.array([0, 1, 2, 3, 4, 5], dtype=np.uint8)  # "$ACGNT"
    assert reverse_complement_i(seq).tolist() == [1, 4, 2, 3, 5, 0]  # "ANCGT$"


def test_round_trip():
    s = "ACGTNACGT$"
    assert convert_itos(convert_stoi(s)) == s


def test_complement_involution():
    assert COMPLEMENT_INT[COMPLEMENT_INT].tolist() == [0, 1, 2, 3, 4, 5]
    assert INT_TO_STRING.tobytes() == b"$ACGNT"
