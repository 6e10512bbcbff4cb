"""The many-query bf16 attention algorithms against the plain versions at
S = 300 (``tests/test_torch_attention_rows.py`` says what is emulated and
why each bound holds)."""

import pytest

from test_torch_attention_rows import CASES, check_against_plain


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("S,D,lengths", CASES[2:])
def test_many_query_algorithms_match_plain(S, D, lengths, rate):
    check_against_plain(S, D, lengths, rate)
