"""The port's copy of the configurations against the JAX package's: every
architecture's full and reduced config, the shapes, the cells and their skip
reasons equal field for field (compared as `dataclasses.asdict`)."""
import dataclasses

import pytest

from repro import configs as jconfigs
from repro_torch import configs

ARCHS = jconfigs.list_archs()


def test_same_architectures():
    assert configs.list_archs() == ARCHS and len(ARCHS) == 10


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch, reduced):
    got = configs.get_config(arch, reduced=reduced)
    want = jconfigs.get_config(arch, reduced=reduced)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__
    assert got.resolved_head_dim == want.resolved_head_dim
    assert got.pattern_for_layers() == want.pattern_for_layers()
    assert (got.sub_quadratic, got.is_encdec) == (want.sub_quadratic, want.is_encdec)


def test_shapes_cells_and_skip_reasons_equal_jax():
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.cells() == jconfigs.cells() and len(configs.cells()) == 40
    for arch, shape in configs.cells():
        assert dataclasses.asdict(configs.get_shape(shape)) == dataclasses.asdict(
            jconfigs.get_shape(shape))
        assert configs.cell_skip_reason(configs.get_config(arch), configs.get_shape(shape)) == \
            jconfigs.cell_skip_reason(jconfigs.get_config(arch), jconfigs.get_shape(shape))


def test_unknown_arch_raises_like_jax():
    for get in (configs.get_config, jconfigs.get_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("no-such-arch")
