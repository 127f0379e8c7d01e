"""The port's PWL tables are bit-identical to the reference's."""
import numpy as np
import pytest

from repro.core import pwl as ref_pwl
from repro.kernels.pwl_eval import pack_table as ref_pack_table
from repro_torch.core import pwl
from repro_torch.kernels.pwl_eval import pack_table

NAMES = ["exp", "gelu", "recip", "rsqrt"]


@pytest.mark.parametrize("segments", [8, 16, 32])
@pytest.mark.parametrize("name", NAMES)
def test_table_bit_identical(name, segments):
    want = ref_pwl.get_table(name, segments)
    got = pwl.get_table(name, segments)
    for field in want._fields:
        w, g = np.asarray(getattr(want, field)), getattr(got, field)
        assert g.dtype == np.float32, field
        np.testing.assert_array_equal(g, w, err_msg=field)
    np.testing.assert_array_equal(pack_table(got), ref_pack_table(want))


@pytest.mark.parametrize("name,segments", [("exp", 18), ("gelu", 18),
                                           ("recip", 16), ("rsqrt", 16)])
def test_guard_segments_count(name, segments):
    """Guard knots at +-65536 add two segments to exp and gelu."""
    t = pwl.get_table(name, 16)
    assert t.num_segments == segments
    assert pack_table(t).shape == (3, segments + 1)
