"""The port's copy of the synthetic Table-I data generator is bitwise
the reference's."""
import pytest

pytest.importorskip("torch")

import warnings  # noqa: E402

import numpy as np  # noqa: E402

from repro.data import dr as jax_dr  # noqa: E402
from repro_torch.data import dr  # noqa: E402


def test_table_i_is_the_reference_table():
    np.testing.assert_array_equal(dr.TABLE_I, jax_dr.TABLE_I)
    assert dr.TABLE_I.dtype == jax_dr.TABLE_I.dtype
    assert int(dr.CLINIC_TOTALS.sum()) == 3657 and dr.N_CLINICS == 14 and dr.N_GRADES == 5


@pytest.mark.parametrize("scale", [1, 2, 16, 64])
def test_scale_table_is_the_reference_scaling(scale):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        np.testing.assert_array_equal(dr.scale_table(scale), jax_dr.scale_table(scale))
    with pytest.raises(ValueError):
        dr.scale_table(0)


@pytest.mark.parametrize("seed,size,scale", [(0, 8, 64), (3, 12, 32)])
def test_make_dr_swarm_data_is_bitwise_the_reference(seed, size, scale):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        table = dr.scale_table(scale)
    ours = dr.make_dr_swarm_data(image_size=size, seed=seed, table=table)
    theirs = jax_dr.make_dr_swarm_data(image_size=size, seed=seed, table=table)
    assert len(ours) == len(theirs) == 14
    for a, b in zip(ours, theirs):
        assert a["n_train"] == b["n_train"]
        for split in ("train", "val", "test"):
            for x, y in zip(a[split], b[split]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
