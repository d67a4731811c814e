"""Shared fixtures."""
import collections

import pytest


@pytest.fixture
def launched():
    """`launched()`: the port's kernel launches since the test began, a
    `collections.Counter` by kernel of each `launch.<kernel>` counter of
    `repro_torch.tracing` that rose (a kernel not launched reads 0)."""
    from repro_torch import tracing

    before = tracing.counts()

    def read() -> collections.Counter:
        return collections.Counter({k.removeprefix("launch."): n
                                    for k, n in (tracing.counts() - before).items()
                                    if k.startswith("launch.")})

    return read
