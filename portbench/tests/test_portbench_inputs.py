"""Captures and weights are made from the seed: the same for the same
seed, different across seeds, whatever the seed's size."""

import numpy as np
import pytest
from conftest import tiny_cell

from portbench import inputs

BIG = 2**31 + 12345


def _same(a, b):
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


@pytest.mark.parametrize("seed", [0, 7, BIG])
def test_captures_follow_the_seed(seed):
    mix = tiny_cell("fenix-cnn.device.iscx").mix
    a, b = inputs.make_captures(mix, seed), inputs.make_captures(mix, seed)
    c = inputs.make_captures(mix, seed + 1)
    assert len(a) == mix["captures"]
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not _same(a[0], c[0]) and not _same(a[0], a[1])
    for cap in a:
        s = inputs.stream_of(cap)
        assert len(s["ts_us"]) == mix["packets"]
        assert np.all(np.diff(s["ts_us"]) >= 0)
        assert s["src_ip"].dtype == np.uint32
        assert cap["windows"].shape == (mix["calib"], 9, 2)


def test_a_mix_too_small_for_its_capture_is_refused():
    mix = dict(tiny_cell("fenix-cnn.device.iscx").mix, flows=2,
               packets=100000)
    with pytest.raises(ValueError):
        inputs.make_captures(mix, 1)


@pytest.mark.parametrize("name", ["fenix-cnn.device.iscx",
                                  "fenix-rnn.device.iscx"])
def test_weights_follow_the_seed(name):
    cell = tiny_cell(name)
    calib = inputs.make_captures(cell.mix, 3)[0]["windows"]
    a = inputs.make_weights(cell.config, 3, calib, "cpu")
    b = inputs.make_weights(cell.config, 3, calib, "cpu")
    c = inputs.make_weights(cell.config, BIG, calib, "cpu")
    assert a.keys() == b.keys() == c.keys()
    arrays = [k for k, v in a.items() if isinstance(v, np.ndarray)]
    assert all(np.array_equal(a[k], b[k]) for k in a if k in arrays)
    assert all(a[k] == b[k] for k in a if k not in arrays)
    assert any(not np.array_equal(a[k], c[k]) for k in arrays)
    assert a["head/w"].dtype == np.int8 and a["head/b"].dtype == np.int32
