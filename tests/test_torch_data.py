"""The port's copy of the synthetic Table-I data generator is bitwise
the reference's."""
import pytest

pytest.importorskip("torch")

import warnings  # noqa: E402

import numpy as np  # noqa: E402

from repro.data import dr as jax_dr  # noqa: E402
from repro_torch.data import dr  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()


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


@pytest.mark.parametrize("n,batch", [(10, 4), (12, 4), (3, 8)])
def test_batch_iterator_is_bitwise_the_references(n, batch):
    """``batch_iterator``: one shuffled epoch, the tail filled from the
    start of the permutation (a split smaller than the batch fills only
    up to twice its size, as the reference does), bitwise the
    reference's on the same seed."""
    X = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    y = np.arange(n, dtype=np.int32)
    got = list(dr.batch_iterator(X, y, batch, np.random.default_rng(5)))
    want = list(jax_dr.batch_iterator(X, y, batch, np.random.default_rng(5)))
    assert len(got) == len(want) == -(-n // batch)
    for (a, b), (c, d) in zip(got, want):
        assert a.shape == (min(batch, 2 * n), 3)
        assert np.array_equal(a, c) and np.array_equal(b, d)
